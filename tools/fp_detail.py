"""Diagnose the stress-corpus FALSE POSITIVES (VERDICT r4 missing #1).

Re-runs the recall_bench corpus through the repo detector and, for every
detection that score() would count as false, prints which scene config
produced it, what it decoded as, where it sits relative to the truth
markers, and its gate statistics (border fraction, bit margin, hamming) —
so the admitting gate can be identified and tightened without giving back
recall.

Usage: python tools/fp_detail.py [--platform cpu] [--quick]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from tools.recall_bench import detect_repo, grid, render_scene

    from arslam.config import ArSlamConfig

    rng = np.random.default_rng(args.seed)
    cfgs, images, truths = [], [], []
    for cfg in grid(args.quick):
        img, truth = render_scene(cfg, rng)
        cfgs.append(cfg)
        images.append(img)
        truths.append(truth)

    windows = tuple(ArSlamConfig().detect.adaptive_thresh_win_sizes)
    dets = detect_repo(images, windows)

    n_fp = 0
    n_hit = 0
    for si, (cfg, per, truth) in enumerate(zip(cfgs, dets, truths)):
        matched = set()
        for dname, items in per.items():
            for mid, center in items:
                ok = False
                for ti, (tdn, tmid, tc, tsize, _) in enumerate(truth):
                    if (tdn == dname and tmid == mid
                            and np.linalg.norm(center - tc) < tsize
                            and ti not in matched):
                        matched.add(ti)
                        ok = True
                        break
                if ok:
                    n_hit += 1
                    continue
                n_fp += 1
                # classify: duplicate of an already-matched truth? near a
                # truth marker of same dict but wrong id? or clutter?
                kind = "clutter"
                detail = ""
                for ti, (tdn, tmid, tc, tsize, _) in enumerate(truth):
                    d = np.linalg.norm(center - tc)
                    if d < tsize:
                        if tdn == dname and tmid == mid:
                            kind = "duplicate"
                            detail = f"truth#{ti} already matched, d={d:.1f}"
                        elif tdn == dname:
                            kind = "wrong-id"
                            detail = (f"truth#{ti} id={tmid} decoded {mid}, "
                                      f"d={d:.1f}")
                        else:
                            kind = "cross-dict"
                            detail = (f"truth#{ti} {tdn}:{tmid} decoded as "
                                      f"{dname}:{mid}, d={d:.1f}")
                        break
                print(f"FP scene={si} cfg={cfg} {dname}:{mid} "
                      f"center=({center[0]:.0f},{center[1]:.0f}) "
                      f"kind={kind} {detail}")
    total = sum(len(t) for t in truths)
    print(f"\nhits={n_hit}/{total} false={n_fp} "
          f"precision={n_hit / max(n_hit + n_fp, 1):.4f}")


if __name__ == "__main__":
    main()
