"""Tag sheet generation (≙ ar_gen, ar_slam/src/ar_gen.cpp).

Renders dictionary markers as printable PNG pages: 8.5x11 in at 100 dpi,
2x3 grid of 2.5 in markers with id labels, files
``aruco<dict>_page<N>.png`` (ar_gen.cpp:53-101).  Pure NumPy/PIL — no GUI
(the reference also imshows each page for 200 ms; headless here).
"""

from __future__ import annotations

import os

import numpy as np

from arslam.detect.dictionaries import get_dictionary


def render_marker(dict_name: str, marker_id: int, pixels: int,
                  border_bits: int = 1) -> np.ndarray:
    """Render one marker as a (pixels, pixels) uint8 image (0=black)."""
    d = get_dictionary(dict_name)
    bits = d.bits[marker_id]
    s = d.marker_size
    n = s + 2 * border_bits
    grid = np.zeros((n, n), dtype=np.uint8)
    grid[border_bits:-border_bits, border_bits:-border_bits] = bits
    cell = pixels // n
    img = np.kron(grid, np.ones((cell, cell), dtype=np.uint8)) * 255
    pad = pixels - img.shape[0]
    if pad > 0:
        img = np.pad(img, ((0, pad), (0, pad)), constant_values=255)
    return img


def place_marker(canvas: np.ndarray, marker: np.ndarray, quad: np.ndarray,
                 quiet: float = 0.0, ss: int = 1) -> np.ndarray:
    """Warp ``marker`` onto ``canvas`` (in place) so that its corners land
    on ``quad`` (TL, TR, BR, BL pixel coords, pixel centers at integers),
    by inverse-homography nearest sampling over the quad's bounding box.

    ``quiet`` adds a white quiet zone of that fraction of the marker side
    on every edge (Aruco detection needs a light margin around the black
    border); the zone is warped through the same homography.  ``ss`` > 1
    averages ss x ss samples per pixel (area anti-aliasing, as a camera
    integrates light over each pixel).
    """
    from arslam.detect.reference import homography_unit_square

    hmat = homography_unit_square(np.asarray(quad, float))
    lo, hi = -quiet, 1.0 + quiet
    box = np.array([[lo, lo, 1], [hi, lo, 1], [hi, hi, 1], [lo, hi, 1]])
    outer = box @ hmat.T
    outer = outer[:, :2] / outer[:, 2:3]
    hgt, wid = canvas.shape
    x0 = max(int(np.floor(outer[:, 0].min())), 0)
    x1 = min(int(np.ceil(outer[:, 0].max())) + 1, wid)
    y0 = max(int(np.floor(outer[:, 1].min())), 0)
    y1 = min(int(np.ceil(outer[:, 1].max())) + 1, hgt)
    if x0 >= x1 or y0 >= y1:
        return canvas
    ys, xs = np.mgrid[y0:y1, x0:x1].astype(float)
    hinv = np.linalg.inv(hmat)
    window = canvas[y0:y1, x0:x1]
    mh, mw = marker.shape
    acc = np.zeros(window.shape)
    hit = np.zeros(window.shape, bool)
    offs = (np.arange(ss) + 0.5) / ss - 0.5
    for oy in offs:
        for ox in offs:
            pts = np.stack([xs + ox, ys + oy, np.ones_like(xs)], axis=-1)
            uvw = pts @ hinv.T
            u = uvw[..., 0] / uvw[..., 2]
            v = uvw[..., 1] / uvw[..., 2]
            in_zone = (u >= lo) & (u < hi) & (v >= lo) & (v < hi)
            in_marker = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
            mx = np.clip((u * mw).astype(int), 0, mw - 1)
            my = np.clip((v * mh).astype(int), 0, mh - 1)
            vals = np.where(in_marker, marker[my, mx], 255)
            acc += np.where(in_zone, vals, window)
            hit |= in_zone
    window[hit] = np.round(acc[hit] / (ss * ss)).astype(canvas.dtype)
    return canvas


def marker_frame(rng: np.random.Generator, height: int, width: int,
                 n_markers: tuple[int, int] = (10, 20),
                 side_px: tuple[float, float] = (40.0, 200.0),
                 dict_names=("4X4_50", "5X5_100"), max_tilt_deg=35.0,
                 ss: int = 3):
    """Render one (height, width) uint8 frame of non-overlapping markers
    under random in-plane rotation and perspective tilt, on a smooth
    illumination gradient (``ss`` x ``ss`` supersampled edges, see
    ``place_marker``).

    Returns (image, truth): truth is a list of (dict_name, marker_id,
    corners (4, 2) float64 in canonical TL, TR, BR, BL order)."""
    gy = np.linspace(0.0, 1.0, height)[:, None]
    gx = np.linspace(0.0, 1.0, width)[None, :]
    img = (150.0 + 40.0 * gx + 20.0 * gy).astype(np.uint8)
    want = int(rng.integers(n_markers[0], n_markers[1] + 1))
    pools = {n: list(rng.permutation(get_dictionary(n).n_markers))
             for n in dict_names}
    placed = []  # (center, radius) of each quiet zone
    truth = []
    for _ in range(4000):
        if len(truth) == want:
            break
        side = float(rng.uniform(*side_px))
        name = dict_names[len(truth) % len(dict_names)]
        n_cells = get_dictionary(name).marker_size + 2
        # the quiet zone is one cell wide; its circumradius bounds overlap
        radius = 0.5 * side * (1.0 + 2.0 / n_cells) * np.sqrt(2.0) * 1.15
        if 2.0 * radius + 4.0 >= min(height, width):
            continue  # this side does not fit the frame
        cx = rng.uniform(radius + 2, width - radius - 2)
        cy = rng.uniform(radius + 2, height - radius - 2)
        if any(np.hypot(cx - c[0], cy - c[1]) < radius + r
               for c, r in placed):
            continue
        quad = _tilted_square(side, rng, max_tilt_deg) + [cx, cy]
        mid = int(pools[name].pop())
        cell = max(int(np.ceil(side / n_cells)), 1)
        place_marker(img, render_marker(name, mid, cell * n_cells), quad,
                     quiet=1.0 / n_cells, ss=ss)
        placed.append(((cx, cy), radius))
        truth.append((name, mid, quad))
    return img, truth


def _tilted_square(side: float, rng: np.random.Generator,
                   max_tilt_deg: float) -> np.ndarray:
    """Corners (TL, TR, BR, BL; clockwise on screen) of a square of about
    ``side`` px, rotated in plane and tilted about a random axis under a
    pinhole projection, centered on the origin."""
    hs = side / 2.0
    pts = np.array([[-hs, -hs, 0], [hs, -hs, 0], [hs, hs, 0], [-hs, hs, 0]])
    ang = rng.uniform(0.0, 2.0 * np.pi)
    ca, sa = np.cos(ang), np.sin(ang)
    pts = pts @ np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]]).T
    tilt = np.deg2rad(rng.uniform(0.0, max_tilt_deg))
    axis = rng.uniform(0.0, np.pi)
    k = np.array([np.cos(axis), np.sin(axis), 0.0])
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    rot = np.eye(3) + np.sin(tilt) * kx + (1 - np.cos(tilt)) * kx @ kx
    p = pts @ rot.T
    focal = 4.0 * side
    z = focal + p[:, 2]
    return p[:, :2] * (focal / z)[:, None]


def generate_pages(
    out_dir: str = ".",
    dict_name: str = "4X4_50",
    dpi: int = 100,
    page_in: tuple[float, float] = (8.5, 11.0),
    marker_in: float = 2.5,
    cols: int = 2,
    rows: int = 3,
) -> list[str]:
    """Write tag sheet pages; returns the file paths."""
    from PIL import Image, ImageDraw

    d = get_dictionary(dict_name)
    page_w, page_h = int(page_in[0] * dpi), int(page_in[1] * dpi)
    marker_px = int(marker_in * dpi)
    per_page = cols * rows
    n_pages = (d.n_markers + per_page - 1) // per_page

    gap_x = (page_w - cols * marker_px) // (cols + 1)
    gap_y = (page_h - rows * marker_px) // (rows + 1)

    paths = []
    for page in range(n_pages):
        canvas = Image.new("L", (page_w, page_h), 255)
        draw = ImageDraw.Draw(canvas)
        for slot in range(per_page):
            marker_id = page * per_page + slot
            if marker_id >= d.n_markers:
                break
            r, c = divmod(slot, cols)
            x = gap_x + c * (marker_px + gap_x)
            y = gap_y + r * (marker_px + gap_y)
            marker = render_marker(dict_name, marker_id, marker_px)
            canvas.paste(Image.fromarray(marker), (x, y))
            draw.text((x, y + marker_px + 4),
                      f"aruco_{dict_name}_{marker_id}", fill=0)
        fn = os.path.join(out_dir,
                          f"aruco{dict_name.lower()}_page{page}.png")
        canvas.save(fn)
        paths.append(fn)
    return paths
