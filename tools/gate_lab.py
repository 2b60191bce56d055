"""Decode-gate lab: measure per-candidate cell statistics on the stress
corpus to SET the precision gates empirically (round-5 FP work).

Runs the recall corpus through the device pipeline at several
(min_strong_cell_frac, strong_cell_dev) settings and reports recall /
precision per setting, so the gate is placed from measurements instead of
distributional assumptions.

Usage: python tools/gate_lab.py [--platform cpu] [--quick]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def detect_with(images, windows, **overrides):
    import jax.numpy as jnp

    from arslam.config import ArSlamConfig
    from arslam.detect.device_detect import DetectParams, detect_batch

    dcfg = ArSlamConfig().detect
    params = DetectParams(win_sizes=tuple(windows),
                          max_candidates=dcfg.max_candidates, **overrides)
    dicts = ("4X4_50", "5X5_100")
    out = []
    bs = 8
    for i in range(0, len(images), bs):
        chunk = images[i:i + bs]
        pad = bs - len(chunk)
        batch = np.stack(chunk + [chunk[-1]] * pad)
        res = detect_batch(jnp.asarray(batch), params=params,
                           dict_names=dicts)
        for j in range(len(chunk)):
            per = {}
            for dname in dicts:
                ids = np.asarray(res[dname]["ids"][j])
                corners = np.asarray(res[dname]["corners"][j])
                valid = np.asarray(res[dname]["valid"][j])
                per[dname] = [
                    (int(ids[k]), corners[k].mean(axis=0))
                    for k in range(len(ids)) if valid[k]
                ]
            out.append(per)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from tools.recall_bench import grid, render_scene, score

    from arslam.config import ArSlamConfig

    rng = np.random.default_rng(args.seed)
    cfgs, images, truths = [], [], []
    for cfg in grid(args.quick):
        img, truth = render_scene(cfg, rng)
        cfgs.append(cfg)
        images.append(img)
        truths.append(truth)
    windows = tuple(ArSlamConfig().detect.adaptive_thresh_win_sizes)

    settings = [
        {"min_otsu_std": 5.0, "min_cell_px": 0.0,
         "min_strong_cell_frac": 0.0},
        {"min_otsu_std": 12.0, "min_cell_px": 0.0,
         "min_strong_cell_frac": 0.0},
        {"min_otsu_std": 5.0, "min_cell_px": 2.0,
         "min_strong_cell_frac": 0.0},
        {"min_otsu_std": 12.0, "min_cell_px": 2.0,
         "min_strong_cell_frac": 0.0},
        {"min_otsu_std": 12.0, "min_cell_px": 2.0,
         "min_strong_cell_frac": 0.25},
    ]
    for ov in settings:
        dets = detect_with(images, windows, **ov)
        hits = false = total = 0
        lost_by = {}
        for cfg, per, truth in zip(cfgs, dets, truths):
            h, f = score(per, truth)
            hits += h
            false += f
            total += len(truth)
            key = (cfg["blur"], cfg["noise"])
            cell = lost_by.setdefault(key, [0, 0])
            cell[0] += h
            cell[1] += len(truth)
        print(f"{ov}: recall {hits/total:.3f} "
              f"precision {hits/max(hits+false,1):.4f} ({false} false)")
        rows = [f"blur={b} noise={n}: {c[0]}/{c[1]}"
                for (b, n), c in sorted(lost_by.items())]
        print("   " + " | ".join(rows))


if __name__ == "__main__":
    main()
