"""End-to-end mapping throughput: captures mapped per second through the
full wave driver (detection excluded; pre-detected observations, like the
reference's pre-processed-detections mode).

The reference re-optimizes the whole growing problem after every capture
(ar_slam_util.cpp:845) — O(n) full LM solves.  solver.optimize_every=k
keeps that contract loosely (seed every wave, optimize every kth) and is
the production knob this harness sweeps.

Usage: python tools/map_bench.py [--tags 200] [--caps 100]
       [--every 1 4 16] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tags", type=int, default=200)
    ap.add_argument("--caps", type=int, default=100)
    ap.add_argument("--every", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--solver", choices=["dense", "cg"], default=None,
                    help="linear solver (cg for large-map runs)")
    ap.add_argument("--save", default="", metavar="PATH",
                    help="also save map.yaml and time the full "
                         "store->waves->map.yaml path (wall_to_map)")
    ap.add_argument("--growth", type=float, default=0.0,
                    help="geometric optimize schedule factor (e.g. 1.25): "
                         "extra full solves early to bound seed-chain "
                         "drift on large fresh maps")
    ap.add_argument("--debug", action="store_true",
                    help="per-flush wall/cost logging")
    ap.add_argument("--loss", choices=["trivial", "huber"], default=None,
                    help="robust loss during construction (huber bounds "
                         "the influence of drifted seeds)")
    ap.add_argument("--polish", type=int, default=0,
                    help="extra LM iterations for one final pass after the "
                         "last wave")
    ap.add_argument("--cg-iters", type=int, default=None,
                    help="CG step cap per LM iteration (--solver cg)")
    ap.add_argument("--cg-tol", type=float, default=None,
                    help="CG relative tolerance (--solver cg)")
    ap.add_argument("--focal-mode", choices=["homography", "fixed"],
                    default=None,
                    help="focal init: homography self-calibration (default) "
                         "or the reference's fixed initial_focal")
    ap.add_argument("--focal", type=float, default=None,
                    help="initial focal for --focal-mode fixed")

    args = ap.parse_args()
    if args.debug:
        import logging

        logging.basicConfig(level=logging.DEBUG, stream=sys.stderr,
                            format="%(asctime)s %(name)s: %(message)s")
        logging.getLogger("jax").setLevel(logging.INFO)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ".")
    from arslam.cli import _enable_compile_cache

    _enable_compile_cache()

    from arslam.config import ArSlamConfig
    from arslam.solve.batch import solve
    from arslam.utils.synthetic import make_synthetic_map

    results = {}
    for every in args.every:
        store, _ = make_synthetic_map(n_tags=args.tags, n_caps=args.caps,
                                      seed=0, noise_px=0.3)
        cfg = ArSlamConfig()
        extra = {}
        if args.solver:
            extra["linear_solver"] = args.solver
        if args.loss:
            extra["loss"] = args.loss
        if args.cg_iters is not None:
            extra["cg_max_iterations"] = args.cg_iters
        if args.cg_tol is not None:
            extra["cg_tolerance"] = args.cg_tol
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, optimize_every=every,
                max_iterations=args.iters, optimize_growth=args.growth,
                final_polish_iterations=args.polish,
                **extra))
        if args.focal_mode:
            cam_extra = {"focal_init_mode": args.focal_mode}
            if args.focal is not None:
                cam_extra["initial_focal"] = args.focal
            cfg = dataclasses.replace(
                cfg, camera=dataclasses.replace(cfg.camera, **cam_extra))
            if args.focal is not None:
                store.camera.params[0] = args.focal
        n = len(store.captures)
        t0 = time.time()
        out = solve(store, cfg)
        solve_wall = time.time() - t0
        save_wall = 0.0
        if args.save:
            from arslam.graph import save_yaml

            t1 = time.time()
            save_yaml(store, args.save)
            save_wall = time.time() - t1
        wall = time.time() - t0
        results[every] = {
            "caps_per_s": round(n / solve_wall, 3),
            "wall_s": round(solve_wall, 2),
            "wall_to_map_s": round(wall, 2),
            "save_s": round(save_wall, 2),
            "rmse_px": round(out.get("rmse", float("nan")), 4),
            "captures": n,
        }
        print(f"optimize_every={every}: {n} caps in {solve_wall:.1f}s "
              f"({n / solve_wall:.2f} caps/s), rmse "
              f"{out.get('rmse', 0):.3f} px"
              + (f", +{save_wall:.1f}s map.yaml" if args.save else ""),
              file=sys.stderr)

    print(json.dumps({"map_throughput": results,
                      "tags": args.tags, "caps": args.caps}))


if __name__ == "__main__":
    main()
