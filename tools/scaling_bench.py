"""Distributed-BA scaling harness (BASELINE config #5).

Measures LM iterations/s of the sharded solver at several mesh sizes on
whatever devices exist (virtual CPU mesh in CI — structural validation;
real GPUs — the interconnect scaling-efficiency number).

Usage:
  python tools/scaling_bench.py [--devices 1 2 4 8] [--tags 500]
  python tools/scaling_bench.py --cpu-mesh 8            # virtual mesh
  python tools/scaling_bench.py --multihost 2           # REAL N-process
      multi-controller run (1 CPU device per process, gloo collectives);
      reports iter/s plus the overhead vs the same-size single-process
      mesh — the multi-controller data plane cost, ≙ "N>=2 hosts" in
      BASELINE.md (on one machine the collectives cross process, not a
      network, so treat it as overhead validation).  The controllers and
      the comparison always run on CPU devices, never on a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _measure(mesh_sizes, args, label_stream=sys.stderr):
    """Shared measurement loop: iter/s of lm_solve_dist per mesh size."""
    import jax
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import build_problem
    from arslam.parallel import block_mesh, lm_solve_dist
    from arslam.solve.lm import LMConfig

    arrs, cap_poses, tag_poses = build_problem(args.tags, args.caps)
    config = LMConfig(max_iterations=args.iters, function_tolerance=0.0,
                      parameter_tolerance=0.0,
                      linear_solver=getattr(args, "solver", "dense"))

    results = {}
    for n in mesh_sizes:
        mesh = block_mesh(n)

        def run():
            return lm_solve_dist(
                mesh, arrs.camera.astype(np.float32), cap_poses, tag_poses,
                arrs.cap_idx, arrs.tag_idx, arrs.corners.astype(np.float32),
                arrs.block_mask, np.asarray(True), arrs.cap_mask,
                arrs.tag_mask, aruco_size=0.0635, config=config,
            )

        out = run()
        jax.block_until_ready(out[0])  # compile
        # best-of-reps: single timed runs on a shared box are noise-bound
        # (observed spread on the gloo simulation: -1%..42% "overhead" from
        # one 20-iteration sample); the max rate is the least-interfered run
        ips = 0.0
        for _ in range(max(getattr(args, "reps", 3), 1)):
            t0 = time.time()
            out = run()
            iters = int(out[3]["iterations"])
            wall = time.time() - t0
            ips = max(ips, iters / wall)
        results[n] = ips
        first = mesh_sizes[0]
        eff = ips / (results[first] * n / first) if n != first else 1.0
        print(f"mesh={n}: {ips:.1f} iter/s  scaling_eff={eff:.2f}",
              file=label_stream)
    return results, int(arrs.n_blocks)


def _multihost_child(args):
    """One controller of the --multihost run (ARSLAM_SB_MH=port,pid,nproc).

    Must initialize the multi-controller runtime before anything touches
    the XLA backend (so before _measure's imports execute jnp constants).
    """
    port, pid, nproc = os.environ["ARSLAM_SB_MH"].split(",")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"127.0.0.1:{port}",
                               num_processes=int(nproc),
                               process_id=int(pid))
    n_dev = jax.device_count()
    stream = sys.stderr if int(pid) == 0 else open(os.devnull, "w")
    results, blocks = _measure([n_dev], args, label_stream=stream)
    if int(pid) == 0:
        print(json.dumps({"mesh_iters_per_s": results, "blocks": blocks,
                          "processes": int(nproc)}))


def _multihost_parent(args):
    """Spawn N single-device controllers; also run the same-size
    single-process mesh locally for the overhead comparison."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n = args.multihost
    env_base = dict(os.environ)
    env_base["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    procs = []
    for pid in range(n):
        env = dict(env_base)
        env["ARSLAM_SB_MH"] = f"{port},{pid},{n}"
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--tags", str(args.tags), "--caps", str(args.caps),
             "--iters", str(args.iters), "--solver", args.solver,
             "--reps", str(args.reps)],
            stdout=subprocess.PIPE,
            stderr=None if pid == 0 else subprocess.DEVNULL,
            text=True, env=env,
        ))
    # on timeout or any failure kill ALL controllers: a gloo peer blocked
    # in a collective otherwise hangs forever and leaks orphans
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    except Exception:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=30)
        raise
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            print(f"controller {pid} failed", file=sys.stderr)
            sys.exit(1)
    mh = json.loads(outs[0].strip().splitlines()[-1])
    mh_ips = list(mh["mesh_iters_per_s"].values())[0]

    # same-size SINGLE-process virtual mesh for the overhead comparison
    out1 = subprocess.run(
        [sys.executable, os.path.abspath(__file__),
         "--cpu-mesh", str(n), "--devices", str(n),
         "--tags", str(args.tags), "--caps", str(args.caps),
         "--iters", str(args.iters), "--solver", args.solver,
         "--reps", str(args.reps)],
        capture_output=True, text=True, timeout=900, check=True,
    )
    sp = json.loads(out1.stdout.strip().splitlines()[-1])
    sp_ips = list(sp["mesh_iters_per_s"].values())[0]
    print(json.dumps({
        "multihost_processes": n,
        "multihost_iters_per_s": mh_ips,
        "single_process_iters_per_s": sp_ips,
        "multi_controller_overhead": 1.0 - mh_ips / sp_ips,
        "blocks": mh["blocks"],
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--tags", type=int, default=500)
    ap.add_argument("--caps", type=int, default=200)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions per mesh size (best-of)")
    ap.add_argument("--solver", choices=["dense", "cg"], default="dense",
                    help="reduced-system solver: dense Cholesky "
                         "(DENSE_SCHUR) or tag-sharded implicit-Schur CG "
                         "(ITERATIVE_SCHUR)")
    ap.add_argument("--cpu-mesh", type=int, default=0,
                    help="force a virtual CPU mesh of this size")
    ap.add_argument("--multihost", type=int, default=0,
                    help="run N separate controller processes (1 CPU "
                         "device each, gloo collectives) instead of a "
                         "virtual mesh")
    args = ap.parse_args()

    if os.environ.get("ARSLAM_SB_MH"):
        return _multihost_child(args)
    if args.multihost:
        return _multihost_parent(args)

    if args.cpu_mesh:
        import jax

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_mesh}"
        ).strip()
        jax.config.update("jax_platforms", "cpu")
    import jax

    n_dev = len(jax.devices())
    sizes = args.devices or sorted({1, 2, n_dev} & set(range(1, n_dev + 1)))
    sizes = [s for s in sizes if s <= n_dev]
    print(f"devices available: {n_dev}; testing mesh sizes {sizes}",
          file=sys.stderr)
    if args.cpu_mesh:
        print(
            "NOTE: virtual CPU mesh — all shards share one host's cores, so "
            "iter/s CANNOT increase with mesh size; this validates "
            "structure/overhead only.  Scaling efficiency needs real cards.",
            file=sys.stderr,
        )
    results, blocks = _measure(sizes, args)
    print(json.dumps({"mesh_iters_per_s": results, "blocks": blocks}))


if __name__ == "__main__":
    main()
