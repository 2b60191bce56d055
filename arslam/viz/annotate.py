"""Headless debug-image annotation.

≙ displayDebug (ar_slam_util.cpp:468-563) without the GUI: scale the image
to ≤800 px, draw each detected rect magenta (250, 0, 250), each projected
tag cyan (250, 250, 0 BGR → yellow-ish; the README legend calls the
projected color cyan, README.md:75-78), and optionally ALL map tags
(undetected ones yellow, 0, 250, 250 BGR) — writing a PNG instead of
cv::imshow.
"""

from __future__ import annotations

import numpy as np

from arslam.core.projection import project_corners
from arslam.graph.store import MapStore

MAGENTA = (250, 0, 250)
CYAN = (0, 250, 250)
YELLOW = (250, 250, 0)


def _draw_poly(draw, pts, color, width=2):
    pts = [tuple(p) for p in pts]
    draw.line(pts + [pts[0]], fill=color, width=width)


def annotate_capture(store: MapStore, cap_idx: int, image: np.ndarray,
                     out_path: str, show_all_tags: bool = False,
                     max_dim: float = 800.0) -> str:
    """Write an annotated debug PNG for one capture; returns the path."""
    from PIL import Image, ImageDraw

    cap = store.captures[cap_idx]
    h, w = image.shape[:2]
    scale = min(max_dim / max(h, w), 1.0)
    img = Image.fromarray(image).convert("RGB")
    if scale < 1.0:
        img = img.resize((int(w * scale), int(h * scale)))
    draw = ImageDraw.Draw(img)
    cx, cy = w * scale / 2.0, h * scale / 2.0

    def to_img(pts):
        return np.asarray(pts) * scale + np.array([cx, cy])

    detected_tags = set()
    for bh in cap.blocks:
        block = store.blocks[bh]
        detected_tags.add(block.tag_idx)
        _draw_poly(draw, to_img(block.corners), MAGENTA)
        proj = project_corners(
            store.camera.params, cap.inv_pose,
            store.arucos[block.tag_idx].pose, 0.0635,
        )
        _draw_poly(draw, to_img(np.asarray(proj)), CYAN)

    if show_all_tags:
        for tag in store.arucos:
            if tag.index in detected_tags:
                continue
            proj = np.asarray(project_corners(
                store.camera.params, cap.inv_pose, tag.pose, 0.0635
            ))
            inside = (np.abs(proj[:, 0]) < w / 2) & (np.abs(proj[:, 1]) < h / 2)
            if inside.all():
                _draw_poly(draw, to_img(proj), YELLOW)

    img.save(out_path)
    return out_path
