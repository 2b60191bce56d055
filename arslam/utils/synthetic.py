"""Synthetic AR-tag map generator for tests and benchmarks.

Builds the BASELINE.json config #5 workload ("500 tags / 200 captures") at
any scale: tags on a planar grid facing +z, cameras above the plane looking
down with jittered poses, observations created with the engine's own
projection model (so ground truth is exactly representable), optional pixel
noise, and FOV-based visibility.
"""

from __future__ import annotations

import numpy as np

from arslam.graph.store import MapStore


def _project_np(camera, inv_cap_pose, tag_pose, aruco_size,
                distortion=False):
    """NumPy mirror of core.projection.project_corners (kept tiny; used only
    to generate synthetic data without device round trips)."""
    from scipy.spatial.transform import Rotation

    dirs = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=float)
    corners = np.concatenate([0.5 * aruco_size * dirs, np.zeros((4, 1))], axis=1)
    p_w = Rotation.from_rotvec(tag_pose[3:6]).apply(corners) + tag_pose[0:3]
    p_c = Rotation.from_rotvec(inv_cap_pose[3:6]).apply(p_w + inv_cap_pose[0:3])
    if np.any(p_c[:, 2] <= 0.1):
        return None
    xy = p_c[:, 0:2] / p_c[:, 2:3]
    if distortion:
        r2 = np.sum(xy * xy, axis=-1, keepdims=True)
        xy = xy * (1.0 + r2 * (camera[1] + camera[2] * r2))
    return camera[0] * xy


def make_synthetic_map(
    n_tags: int = 24,
    n_caps: int = 12,
    focal: float = 3000.0,
    image_size: tuple[int, int] = (4000, 3000),
    aruco_size: float = 0.0635,
    tag_spacing: float = 0.25,
    height: float = 1.8,
    noise_px: float = 0.0,
    seed: int = 0,
    min_tags_per_cap: int = 2,
    radial: tuple[float, float] = (0.0, 0.0),
) -> tuple[MapStore, dict]:
    """Generate a MapStore with observations and return (store, ground_truth).

    ground_truth holds the exact poses used for generation:
      {"cap_poses": (n_caps, 6) inverse poses, "tag_poses": (n_tags, 6),
       "camera": (3,)}
    """
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_tags)))

    tag_poses = np.zeros((n_tags, 6))
    for t in range(n_tags):
        gx, gy = t % side, t // side
        tag_poses[t, 0] = (gx - (side - 1) / 2) * tag_spacing
        tag_poses[t, 1] = (gy - (side - 1) / 2) * tag_spacing
        tag_poses[t, 2] = 0.0
        tag_poses[t, 3:5] = rng.normal(scale=0.05, size=2)  # slight tilt
        tag_poses[t, 5] = rng.normal(scale=0.3)  # in-plane rotation

    extent = side * tag_spacing
    cap_poses = np.zeros((n_caps, 6))
    # serpentine 2-D sweep over the grid so every tag is observed and
    # neighbouring captures overlap (connected graph)
    sweep_rows = max(int(np.sqrt(n_caps)), 1)
    sweep_cols = (n_caps + sweep_rows - 1) // sweep_rows
    for c in range(n_caps):
        r_i, c_i = divmod(c, sweep_cols)
        if r_i % 2 == 1:
            c_i = sweep_cols - 1 - c_i  # serpentine for overlap continuity
        fx = c_i / max(sweep_cols - 1, 1)
        fy = r_i / max(sweep_rows - 1, 1)
        cx = (fx - 0.5) * extent * 0.9 + rng.normal(scale=0.05)
        cy = (fy - 0.5) * extent * 0.9 + rng.normal(scale=0.05)
        cz = height + rng.normal(scale=0.1)
        # looking straight down: R = Rx(pi) + jitter
        rot = np.array([np.pi, 0.0, 0.0]) + rng.normal(scale=0.08, size=3)
        cap_poses[c, 0:3] = -np.array([cx, cy, cz])  # t_inv = -position
        cap_poses[c, 3:6] = rot  # R_inv ~ Rx(pi): world -> camera

    camera = np.array([focal, radial[0], radial[1]])
    distort = any(radial)
    store = MapStore(initial_focal=focal)
    store.camera.size = image_size
    half_w, half_h = image_size[0] / 2, image_size[1] / 2

    # Vectorized projection: the naive per-(capture, tag) scipy loop is
    # O(C*T) Python calls — hours at the 10k-tag / 4k-capture scale the
    # solver now handles.  Project ALL tags per capture in one shot; noise
    # is still drawn per visible detection in ascending-tag order so the
    # rng stream (and thus every seeded fixture) is unchanged.
    from scipy.spatial.transform import Rotation

    dirs = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=float)
    corners_local = np.concatenate(
        [0.5 * aruco_size * dirs, np.zeros((4, 1))], axis=1)  # (4, 3)
    r_tags = Rotation.from_rotvec(tag_poses[:, 3:6]).as_matrix()  # (T,3,3)
    p_w = (np.einsum("tij,cj->tci", r_tags, corners_local)
           + tag_poses[:, None, 0:3])  # (T, 4, 3)

    # chunk the capture axis: one (K, T, 4, 3) einsum per chunk instead of
    # 4000 small per-capture matmuls (memory stays ~100 MB/chunk at 10k tags)
    # ~50 MB of (K, T*4, 3) float64 temporaries per chunk: big enough to
    # amortize Python dispatch, small enough to stay cache/bandwidth friendly
    chunk = max(1, min(n_caps, int(5e5 // max(n_tags, 1)) or 1))
    for c0 in range(0, n_caps, chunk):
        c1 = min(c0 + chunk, n_caps)
        r_inv = Rotation.from_rotvec(cap_poses[c0:c1, 3:6]).as_matrix()
        # p_c[k] = (p_w + pos_k) @ R_k^T as a batched GEMM — the SAME
        # contraction order as the per-capture loop this replaced, so
        # seeded fixtures stay bit-identical (a factored
        # p_w@R^T + R@pos form rounds differently and could flip a tag
        # sitting exactly on the visibility boundary, desyncing the RNG)
        flat = p_w.reshape(-1, 3)  # (T*4, 3)
        shifted = flat[None] + cap_poses[c0:c1, None, 0:3]  # (K, T*4, 3)
        p_c = np.matmul(shifted, r_inv.transpose(0, 2, 1))
        p_c = p_c.reshape(c1 - c0, -1, 4, 3)
        z_ok = np.all(p_c[:, :, :, 2] > 0.1, axis=2)  # (K, T)
        with np.errstate(divide="ignore", invalid="ignore"):
            xy = p_c[:, :, :, 0:2] / p_c[:, :, :, 2:3]
            if distort:
                r2 = np.sum(xy * xy, axis=-1, keepdims=True)
                xy = xy * (1.0 + r2 * (camera[1] + camera[2] * r2))
            uv_chunk = camera[0] * xy  # (K, T, 4, 2)
        with np.errstate(invalid="ignore"):
            in_img = (np.all(np.abs(uv_chunk[:, :, :, 0]) <= half_w, axis=2)
                      & np.all(np.abs(uv_chunk[:, :, :, 1]) <= half_h, axis=2))
        vis = z_ok & in_img
        # one rng draw for the whole chunk: Generator.normal fills the
        # output from the same bit stream in the same order as the
        # equivalent sequence of per-detection (4, 2) draws, so seeded
        # fixtures are unchanged (asserted vs the per-det loop in tests)
        ks, ts = np.nonzero(vis)
        obs_all = uv_chunk[ks, ts]
        if noise_px:
            obs_all = obs_all + rng.normal(scale=noise_px,
                                           size=obs_all.shape)
        counts = np.bincount(ks, minlength=c1 - c0)
        off = 0
        for k, n_k in enumerate(counts.tolist()):
            if n_k >= min_tags_per_cap:
                obs_k = obs_all[off:off + n_k]
                dets = [(f"aruco_4X4_50_{t}", obs_k[j])
                        for j, t in enumerate(ts[off:off + n_k].tolist())]
                store.add_detections(f"cap_{c0 + k}", dets, image_size)
            off += n_k

    truth = {"cap_poses": cap_poses, "tag_poses": tag_poses, "camera": camera}
    return store, truth


def render_capture(inv_pose: np.ndarray, tag_poses: np.ndarray,
                   tag_markers, camera: np.ndarray,
                   image_size: tuple[int, int], aruco_size: float = 0.0635,
                   ss: int = 3) -> np.ndarray:
    """Render one capture of a synthetic scene as a (height, width) uint8
    image, NumPy only.

    Each tag ``t`` is drawn as marker ``tag_markers[t] = (dict_name,
    marker_id)`` warped onto its projected corners (the same pinhole model
    as the observations ``make_synthetic_map`` creates, so the detected
    corners of a rendered tag are its synthetic observation), with the
    one-cell white quiet zone detection needs.  Tags whose quiet zone is
    not wholly in view are left out.  ``ss`` x ``ss`` supersampling
    anti-aliases edges the way a sensor integrates light over a pixel.
    """
    from arslam.detect.dictionaries import get_dictionary
    from arslam.detect.gen import place_marker, render_marker

    width, height = image_size
    gy = np.linspace(0.0, 1.0, height)[:, None]
    gx = np.linspace(0.0, 1.0, width)[None, :]
    img = (150.0 + 40.0 * gx + 20.0 * gy).astype(np.uint8)
    center = np.array([width / 2.0, height / 2.0])
    for t, (dict_name, marker_id) in enumerate(tag_markers):
        uv = _project_np(camera, inv_pose, tag_poses[t], aruco_size)
        if uv is None:
            continue
        quad = uv + center
        n_cells = get_dictionary(dict_name).marker_size + 2
        # quiet-zone outline: the quad pushed out by one cell per side
        mid = quad.mean(axis=0)
        outer = mid + (quad - mid) * (1.0 + 2.0 / n_cells)
        if (outer.min() < 2.0 or outer[:, 0].max() > width - 3.0
                or outer[:, 1].max() > height - 3.0):
            continue
        side = np.linalg.norm(quad - np.roll(quad, -1, axis=0), axis=1).max()
        cell = max(int(np.ceil(side / n_cells)), 1)
        place_marker(img, render_marker(dict_name, int(marker_id),
                                        cell * n_cells),
                     quad, quiet=1.0 / n_cells, ss=ss)
    return img
