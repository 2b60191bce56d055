"""Single-chip LARGE-MAP benchmark: the round-1 memory-wall scale.

Round 1's dense (T, 3+6C, 6) coupling slab was ~5.8 GB at 10k tags / 4k
captures before the solver even ran.  The capture-sparse layout is
O(observations); this tool proves the scale on one device and measures
iter/s with the implicit-Schur CG (the dense reduced
Cholesky is O((6C)^3) and is not meaningful at this capture count — ceres'
DENSE_SCHUR would be in the same regime).

Usage: python tools/big_map_bench.py [--tags 10000] [--caps 4000]
       [--iters 12] [--solver cg]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tags", type=int, default=10000)
    ap.add_argument("--caps", type=int, default=4000)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--solver", choices=["cg", "dense"], default="cg")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also trace one full solve (jax.profiler) into "
                         "DIR")
    ap.add_argument("--cg-tol", type=float, default=None)
    # the SCHUR_JACOBI-preconditioned CG does not reach tol 1e-2 within 100
    # steps at this scale, so a cap binds and the LM trust region absorbs
    # the inexactness; 25 steps landed within 2% of the 100-step cost
    ap.add_argument("--cg-iters", type=int, default=25)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    from bench import bench_lm, build_problem, log

    from arslam.cli import _enable_compile_cache

    _enable_compile_cache()

    dev = jax.devices()[0]
    log(f"device: {dev}")
    arrs, cap_poses, tag_poses = build_problem(args.tags, args.caps)
    out = bench_lm(arrs, cap_poses, tag_poses, dev, n_iters=args.iters,
                   n_lo=max(args.iters // 4, 1), linear_solver=args.solver,
                   profile_dir=args.profile, cg_tol=args.cg_tol,
                   cg_iters=args.cg_iters)

    # accuracy columns: reprojection RMSE from the final cost, and camera-
    # trajectory ATE of the solved poses vs the generator's ground truth
    # (arrs holds the TRUTH poses; the solver started from the perturbed
    # copies).  Noise floor: the synthetic observations carry 0.3 px noise,
    # so a converged solve lands near rmse_px ~= 0.3.
    import numpy as np

    from arslam.utils.ate import ate_rmse

    n_blocks = int(arrs.n_blocks)
    rmse_px = float(np.sqrt(2.0 * out["final_cost"] / (8 * n_blocks)))
    truth_pos = -np.asarray(arrs.cap_poses[: arrs.n_caps, 0:3])
    solved_pos = -np.asarray(out["cap_poses"][: arrs.n_caps, 0:3])
    ate_m = ate_rmse(solved_pos, truth_pos)

    print(json.dumps({
        "metric": f"ba_iterations_per_s_{args.tags}tag_{args.caps}cap",
        "value": round(out["iters_per_s"], 3),
        "unit": "iter/s",
        "extra": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "solver": args.solver,
            "blocks": n_blocks,
            "compile_s": round(out["compile_s"], 1),
            "final_cost": out["final_cost"],
            "iterations": out["iterations"],
            "rmse_px": round(rmse_px, 4),
            "ate_m": round(ate_m, 6),
        },
    }))


if __name__ == "__main__":
    main()
