"""Benchmark harness — prints one JSON line.

Headline: BA iterations/s on the 500-tag / 200-capture synthetic map
(BASELINE.json config #5) on the GPU, plus demo-map quality, localization
throughput and detection frames/s on seeded rendered frames.
``vs_baseline`` compares against the host-CPU run of the same solver in
the same process (the reference publishes no numbers — BASELINE.md — so
the CPU path stands in as the Ceres-equivalent baseline).  Without a GPU
it exits non-zero: no CPU number is reported as a device number.

    python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_problem(n_tags=500, n_caps=200, dtype=np.float32, seed=0):
    from arslam.graph.arrays import export_arrays
    from arslam.utils.synthetic import make_synthetic_map

    t0 = time.time()
    store, truth = make_synthetic_map(
        n_tags=n_tags, n_caps=n_caps, seed=seed, noise_px=0.3,
        focal=3000.0,
    )
    for cap in store.captures:
        cap.inv_pose[:] = truth["cap_poses"][int(cap.uid.split("_")[1])]
    for tag in store.arucos:
        tag.pose[:] = truth["tag_poses"][int(tag.id.split("_")[-1])]
    arrs = export_arrays(store, dtype=dtype)
    rng = np.random.default_rng(1)
    cap_poses = (arrs.cap_poses
                 + rng.normal(scale=0.005, size=arrs.cap_poses.shape)).astype(dtype)
    tag_poses = (arrs.tag_poses
                 + rng.normal(scale=0.005, size=arrs.tag_poses.shape)).astype(dtype)
    log(f"synthetic problem: {arrs.n_caps} caps, {arrs.n_tags} tags, "
        f"{arrs.n_blocks} blocks (gen {time.time()-t0:.1f}s)")
    return arrs, cap_poses, tag_poses


def solver_layout(arrs, linear_solver="dense") -> dict:
    """Static slot-layout arguments of ``lm_solve`` for an exported problem:
    the tag-grouped scatter-free assembly (the production path), plus
    row-split slot packing for CG (ROW_SLOTS-wide rows, a tag spanning
    several rows — ~1.2x padding instead of the (T, S_max) rectangle's
    mean/max ratio)."""
    counts = np.bincount(arrs.tag_idx[arrs.block_mask],
                         minlength=arrs.tag_poses.shape[0])
    ccounts = np.bincount(arrs.cap_idx[arrs.block_mask],
                          minlength=arrs.cap_poses.shape[0])
    layout = {"obs_per_tag": -(-int(counts.max()) // 8) * 8,
              "obs_per_cap": -(-int(ccounts.max()) // 8) * 8,
              "row_slots": None, "tag_rows": None, "cap_rows": None}
    if linear_solver == "cg":
        row_slots = 8
        need = int(np.ceil(counts / row_slots).sum())
        need_c = int(np.ceil(ccounts / row_slots).sum())
        layout.update(row_slots=row_slots,
                      tag_rows=-(-need // 256) * 256,
                      cap_rows=-(-need_c // 256) * 256)
    return layout


def bench_lm(arrs, cap_poses, tag_poses, device, n_iters=32, dtype=np.float32,
             n_lo=None, linear_solver="dense", profile_dir=None,
             cg_tol=None, cg_iters=None):
    """Marginal LM iteration rate: time the same solve at two iteration
    budgets and divide the difference — excluding the fixed per-call cost
    (dispatch, initial linearization, transfers), which otherwise
    dominates short solves."""
    import jax
    import jax.numpy as jnp

    from arslam.solve.lm import LMConfig, lm_solve

    n_lo = n_lo if n_lo is not None else max(n_iters // 4, 1)

    with jax.default_device(device):
        args = tuple(
            jax.device_put(jnp.asarray(x), device)
            for x in (
                arrs.camera.astype(dtype), cap_poses, tag_poses,
                arrs.cap_idx, arrs.tag_idx, arrs.corners.astype(dtype),
                arrs.block_mask,
            )
        )
        cam_a = jax.device_put(jnp.asarray(True), device)
        cap_m = jax.device_put(jnp.asarray(arrs.cap_mask), device)
        tag_m = jax.device_put(jnp.asarray(arrs.tag_mask), device)

        config = LMConfig(max_iterations=n_iters, function_tolerance=0.0,
                          parameter_tolerance=0.0,
                          linear_solver=linear_solver)
        if cg_tol is not None:
            config = config._replace(cg_tolerance=cg_tol)
        if cg_iters is not None:
            config = config._replace(cg_max_iterations=cg_iters)
        layout = solver_layout(arrs, linear_solver)

        def run(n):
            # traced iteration budget: ONE compiled program serves both
            # timing points
            return lm_solve(
                *args[:7], cam_a, cap_m, tag_m,
                aruco_size=0.0635, config=config,
                iter_budget=jnp.asarray(n, jnp.int32), **layout,
            )

        def timed(n, reps=4):
            """Best-of-N repetition timing: single timed runs on this shared
            box spread −1%…42% (CLAUDE.md), so the minimum — not the mean —
            estimates the un-contended rate."""
            t0 = time.time()
            out = run(n)
            iters = int(out[3]["iterations"])
            compile_s = time.time() - t0
            walls = []
            for _ in range(reps):
                t0 = time.time()
                out = run(n)
                int(out[3]["iterations"])  # sync
                walls.append(time.time() - t0)
            spread = (max(walls) - min(walls)) / max(min(walls), 1e-9)
            return min(walls), iters, compile_s, out, spread

        wall_lo, it_lo, compile_lo, _, _ = timed(n_lo)
        # second budget reuses the same compiled program (traced budget) —
        # its "compile" is just a warm dispatch
        wall_hi, it_hi, _, (_, caps_out, tags_out, info), spread = (
            timed(n_iters))
        cost = float(info["cost"])
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            with jax.profiler.trace(profile_dir):
                int(run(n_iters)[3]["iterations"])  # sync inside the trace
    if it_hi > it_lo:
        marginal = (wall_hi - wall_lo) / (it_hi - it_lo)
    else:  # solver converged/stalled inside the low budget
        marginal = wall_hi / max(it_hi, 1)
    return {
        "iters_per_s": 1.0 / marginal,
        "wall_s": wall_hi,
        "fixed_overhead_s": max(wall_lo - marginal * it_lo, 0.0),
        "compile_s": compile_lo,
        "iterations": it_hi,
        "final_cost": cost,
        "rep_spread": spread,
        # solved pose state (for accuracy columns: reprojection RMSE is
        # sqrt(2*cost/(8*B)); ATE comes from comparing these to the
        # generator's ground truth)
        "cap_poses": np.asarray(caps_out),
        "tag_poses": np.asarray(tags_out),
    }


def bench_demo(dtype=np.float32):
    import yaml

    from arslam.config import ArSlamConfig
    from arslam.graph import MapStore
    from arslam.solve import localize_many, solve_batch

    fixture = os.path.join(REPO, "tests", "fixtures", "demo_detections.yaml")
    data = yaml.safe_load(open(fixture))

    def fresh_store():
        s = MapStore()
        for cap in data["captures"][:3]:
            dets = [(d["id"], np.array(d["corners"]).reshape(4, 2))
                    for d in cap["detections"]["4X4_50"]]
            s.add_detections(cap["uid"], dets,
                             (cap["width"], cap["height"]), cap["img_fn"])
        return s

    # cold = first in-process solve: tracing the wave program plus its
    # compile (or a load from the persistent compile cache).  warm =
    # steady-state re-solve (what a serve loop pays per map): same
    # program, fresh store.
    store = fresh_store()
    t0 = time.time()
    summary = solve_batch(store, ArSlamConfig(), dtype=dtype)
    demo_cold = time.time() - t0
    walls = []
    for _ in range(3):
        s2 = fresh_store()
        t0 = time.time()
        summary = solve_batch(s2, ArSlamConfig(), dtype=dtype)
        walls.append(time.time() - t0)
        store = s2
    demo_wall = min(walls)

    cap4 = data["captures"][3]
    first = store.next_capture_index
    dets = [(d["id"], np.array(d["corners"]).reshape(4, 2))
            for d in cap4["detections"]["4X4_50"]]
    store.add_detections(cap4["uid"], dets, (cap4["width"], cap4["height"]),
                         cap4["img_fn"])
    t0 = time.time()
    loc = localize_many(store, first, ArSlamConfig())
    loc_wall = time.time() - t0
    out = {
        "demo_rmse_px": summary["rmse"],
        "demo_solve_s": demo_wall,
        "demo_solve_cold_s": demo_cold,
        "localize_rmse_px": loc["rmse"],
        "localize_s": loc_wall,
    }
    out["localize_caps_per_s"] = bench_localize_throughput(store, dtype)
    return out


def bench_localize_throughput(store, dtype, q=256, reps=3):
    """Steady-state captures-localized/s: the img4 query replicated q times
    through the vmapped pose-only kernel (BASELINE 'captures localized/s';
    the reference rebuilds a ceres problem per query)."""
    import jax
    import jax.numpy as jnp

    from arslam.config import ArSlamConfig
    from arslam.solve.batch import _lm_config
    from arslam.solve.localize import localize_kernel

    config = ArSlamConfig()
    cap = store.captures[-1]  # the localized img4 query
    blocks = [store.blocks[bh] for bh in cap.blocks]
    k = len(blocks)
    t_pad = max(len(store.arucos), 1)
    tag_poses = np.zeros((t_pad, 6), dtype=dtype)
    for tag in store.arucos:
        tag_poses[tag.index] = tag.pose
    q_tag_idx = np.tile(
        np.array([b.tag_idx for b in blocks], dtype=np.int32), (q, 1))
    q_corners = np.tile(
        np.stack([b.corners for b in blocks]).astype(dtype), (q, 1, 1, 1))
    q_mask = np.ones((q, k), dtype=bool)
    q_seed = np.zeros(q, dtype=np.int32)

    def run():
        poses, costs, _ = localize_kernel(
            jnp.asarray(store.camera.params, dtype=dtype),
            jnp.asarray(tag_poses), jnp.asarray(q_tag_idx),
            jnp.asarray(q_corners), jnp.asarray(q_mask), jnp.asarray(q_seed),
            aruco_size=config.aruco_size,
            config=_lm_config(config.solver),
            seed_mode=config.solver.seed_mode,
        )
        return jax.block_until_ready(costs)

    run()  # compile
    walls = []  # best-of-N (shared-box noise)
    for _ in range(reps):
        t0 = time.time()
        costs = run()
        walls.append(time.time() - t0)
    assert np.isfinite(np.asarray(costs)).all()
    return q / min(walls)


def bench_detection(batch_size=8, reps=5, seed=0, height=768, width=1020):
    """Detection frames/s on seeded rendered frames (batched device
    pipeline; 10-20 markers of 40-200 px per frame, both dictionaries).

    Headline = the PRODUCTION default (cv2-equivalent adaptive-window sweep
    3/13/23 from DetectConfig); the single-window (23) rate is reported as
    ``frames_per_s_single_win`` for the controlled-imagery fast path."""
    import jax
    import jax.numpy as jnp

    from arslam.config import ArSlamConfig
    from arslam.detect.device_detect import DetectParams, detect_batch
    from arslam.detect.gen import marker_frame

    rng = np.random.default_rng(seed)
    frames = [marker_frame(rng, height, width) for _ in range(batch_size)]
    batch = jnp.asarray(np.stack([f[0] for f in frames]))
    want = sorted(int(m) for n, m, _ in frames[0][1] if n == "4X4_50")
    dcfg = ArSlamConfig().detect
    sweep = DetectParams(win_sizes=tuple(dcfg.adaptive_thresh_win_sizes),
                         max_candidates=dcfg.max_candidates)
    single = DetectParams(win_sizes=(dcfg.adaptive_thresh_win_sizes[-1],),
                          max_candidates=dcfg.max_candidates)

    def timed(params):
        t0 = time.time()
        out = detect_batch(batch, params=params)
        jax.block_until_ready(out)
        compile_s = time.time() - t0
        walls = []  # best-of-N: shared-box noise spreads −1%…42%
        for _ in range(reps):
            t0 = time.time()
            out = detect_batch(batch, params=params)
            jax.block_until_ready(out)
            walls.append(time.time() - t0)
        dt = min(walls)
        # pipelined steady state: enqueue ``reps`` batches, sync once —
        # async dispatch overlaps host dispatch with device compute, which
        # is how the serve pipeline drives the device
        t0 = time.time()
        outs = [detect_batch(batch, params=params) for _ in range(reps)]
        jax.block_until_ready(outs)
        dt_pipe = (time.time() - t0) / reps
        # sanity: the rendered 4X4_50 ids of frame 0 must all appear
        ids0 = sorted(int(i)
                      for i in np.asarray(out["4X4_50"]["ids"][0]) if i >= 0)
        if ids0 != want:
            raise RuntimeError(f"detection ids {ids0} != rendered {want}")
        return batch_size / dt, dt * 1000, compile_s, batch_size / dt_pipe

    fps, batch_ms, compile_s, fps_pipe = timed(sweep)
    fps1, _, compile1, fps1_pipe = timed(single)
    return {
        "frames_per_s": fps,
        "frames_per_s_pipelined": fps_pipe,
        "batch_ms": batch_ms,
        "compile_s": compile_s + compile1,
        "frames_per_s_single_win": fps1,
        "frames_per_s_single_win_pipelined": fps1_pipe,
    }


def card_info() -> str:
    """``nvidia-smi`` name and power limit of every card, or why not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    if out.returncode != 0 or not out.stdout.strip():
        return f"unavailable (nvidia-smi rc {out.returncode})"
    return "; ".join(out.stdout.strip().splitlines())


def main():
    card = card_info()  # before JAX starts
    import jax

    from arslam.cli import _enable_compile_cache

    _enable_compile_cache()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: no GPU (JAX platform {dev.platform!r})")
    log(f"benchmark device: {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())} ({card})")
    arrs, cap_poses, tag_poses = build_problem()

    accel = bench_lm(arrs, cap_poses, tag_poses, dev)
    log("accel: %s" % {k: v for k, v in accel.items()
                       if not isinstance(v, np.ndarray)})

    # CPU float32 baseline: the same solver on the host CPU device
    cpu = jax.devices("cpu")[0]
    base = bench_lm(arrs, cap_poses, tag_poses, cpu, n_iters=5, n_lo=1)
    log("cpu baseline: %s" % {k: v for k, v in base.items()
                              if not isinstance(v, np.ndarray)})
    vs_baseline = accel["iters_per_s"] / base["iters_per_s"]

    demo = bench_demo()
    log(f"demo: {demo}")

    det = bench_detection()
    log(f"detection: {det}")

    result = {
        "metric": "ba_iterations_per_s_500tag",
        "value": round(accel["iters_per_s"], 3),
        "unit": "iter/s",
        "vs_baseline": round(vs_baseline, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "extra": {
            "blocks": int(arrs.n_blocks),
            "compile_s": round(accel["compile_s"], 1),
            "final_cost": accel["final_cost"],
            "rep_spread": round(accel.get("rep_spread", 0.0), 3),
            "detect_frames_per_s": round(det["frames_per_s"], 2),
            "detect_frames_per_s_pipelined": round(
                det.get("frames_per_s_pipelined", 0.0), 2),
            "detect_frames_per_s_single_win": round(
                det.get("frames_per_s_single_win", 0.0), 2),
            "detect_frames_per_s_single_win_pipelined": round(
                det.get("frames_per_s_single_win_pipelined", 0.0), 2),
            **{k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in demo.items()},
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
