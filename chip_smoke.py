"""Smoke run of the main path on one GPU: detection at camera resolution,
images in / map.yaml out through the CLI, localize, the serve pipeline, and
the solver at deployment size — each checked against a plain reference.

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --four     # four cards: the mesh paths only

Everything runs in this one process (a second JAX process could not get
the card's memory).  All inputs are generated from ``--seed``.  The first
line names the card and the environment; one line per phase gives its wall
time (set-up = generation + compile, run) and its figures against their
bounds; the last line is one JSON object.  Any failed bound makes the exit
code non-zero; an exception propagates.  Without a GPU the script exits
non-zero before running anything.

Each ``phase_*`` function takes its sizes as arguments, so the tests call
them at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DICTS = ("4X4_50", "5X5_100")
ARUCO_SIZE = 0.0635  # m, the synthetic scene's tag side

# ---- bounds, each with its reason --------------------------------------
# device detector vs NumPy oracle, per corner: both refine to sub-pixel
# from different starting quads (decimated extreme points vs full-res hull)
# with differently ordered float32 window sums, so a few corners settle
# apart (CPU rehearsal over 476 corners at both sizes: median 0.013 px,
# p95 0.29 px, max 1.2 px).  The oracle also reports rare false ids (small
# inner squares that the device's cross-dictionary arbitration rejects),
# so its ids are compared after dropping those not in the renderer's truth.
CORNER_MEDIAN_PX = 0.1
CORNER_P95_PX = 0.5
CORNER_MAX_PX = 1.5
# one program, sharded or not: only reduction order may differ
SHARDED_CORNER_MAX_PX = 0.5
# the renderer's truth: every marker whose shortest projected side is at
# least this many pixels must be found
MIN_FOUND_SIDE_PX = 40.0
# map built from rendered images: detection error only (no pixel noise)
MAP_RMSE_PX = 1.0
FOCAL_REL = 0.02
TAG_ATE_M = 0.005
# localized pose: the 1 cm aim is out of the renderer's reach at seed 0 —
# the CPU rehearsal of the same captures puts the worst held-out pose at
# 9.89 mm (f32) and 10.09 mm (f64 re-solve of the same detections), so the
# bound is that figure plus a 20 % margin for CPU/GPU reduction order
LOC_POS_M = 0.012
LOC_ROT_DEG = 1.0
# f32 on the card vs f64 on the host CPU: same solver, same iterations;
# precision and reduction order differ, the optimum does not
DENSE_COST_REL = 1e-3
# the solver problems carry 0.3 px observation noise: a converged solve
# sits just under it
RMSE_FLOOR_PX = (0.27, 0.31)
CG_RMSE_PX = 0.31
# four cards vs one: dense is the same algorithm with psum'd reductions;
# CG stops at a step cap, so inexact steps land at a nearby cost
DIST_DENSE_REL = 1e-3
DIST_CG_REL = 2e-2


class Checks:
    """Figures of one phase against their bounds."""

    def __init__(self):
        self.rows: list[tuple[str, object, str, bool]] = []

    def add(self, name: str, value, bound: str, ok: bool):
        self.rows.append((name, value, bound, bool(ok)))

    @property
    def ok(self) -> bool:
        return all(r[3] for r in self.rows)

    def line(self) -> str:
        def fmt(v):
            if isinstance(v, float):
                return f"{v:.6g}"
            return str(v)
        return "; ".join(f"{n}={fmt(v)} ({b}: {'ok' if ok else 'FAIL'})"
                         for n, v, b, ok in self.rows)


def report(name: str, checks: Checks, times: dict, extra: dict | None = None):
    t = ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
    print(f"phase {name}: {'PASS' if checks.ok else 'FAIL'} [{t}] "
          f"{checks.line()}", flush=True)
    if extra:
        print(f"  {name} detail: {json.dumps(extra, default=str)}",
              flush=True)


def build_native() -> dict:
    """``make -C native``; the pure-Python store and decoders are used for
    whatever does not build."""
    native = os.path.join(REPO, "native")
    proc = subprocess.run(["make", "-C", native], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        print(proc.stderr[-2000:], file=sys.stderr)
    return {lib: os.path.exists(os.path.join(native, f"libarslam_{lib}.so"))
            for lib in ("graph", "jpeg")}


def _have(module: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(module) is not None


# ---- detection -----------------------------------------------------------

def render_frames(seed: int, n: int, height: int, width: int):
    """``n`` frames of 10-20 markers (40-200 px, both dictionaries)."""
    from arslam.detect.gen import marker_frame

    rng = np.random.default_rng(seed)
    return [marker_frame(rng, height, width, dict_names=DICTS)
            for _ in range(n)]


def detections(out, i: int) -> dict:
    """{(dict_name, id): corners (4, 2)} of image ``i`` of a detect_batch
    result."""
    found = {}
    for name in DICTS:
        ids = np.asarray(out[name]["ids"][i])
        valid = np.asarray(out[name]["valid"][i])
        corners = np.asarray(out[name]["corners"][i])
        for k in np.nonzero(valid)[0]:
            found[(name, int(ids[k]))] = corners[k]
    return found


def compare_detections(got: dict, want: dict) -> tuple[bool, list]:
    """(equal key sets, per-corner distances on shared keys)."""
    shared = sorted(set(got) & set(want))
    dist = [float(d) for k in shared
            for d in np.linalg.norm(got[k] - want[k], axis=1)]
    return set(got) == set(want), dist


def truth_misses(found: dict, truth) -> tuple[int, int]:
    """(markers of MIN_FOUND_SIDE_PX or more not found, false ids)."""
    want = {(n, m): q for n, m, q in truth}
    big = {k for k, q in want.items()
           if np.linalg.norm(q - np.roll(q, -1, axis=0), axis=1).min()
           >= MIN_FOUND_SIDE_PX}
    return len(big - set(found)), len(set(found) - set(want))


def scope_of(op_name: str, names) -> str:
    """The innermost of ``names`` that is a path component of an HLO
    ``op_name`` ("other" if none).  A component matches a name exactly or
    with a "_suffix" (``detect_decode_4X4_50`` is ``detect_decode``), after
    unwrapping transforms (``vmap(detect_extract)``); merged instructions
    join their op_names with ";"."""
    hits = []
    for part in re.split(r"[/;]", op_name):
        while (m := re.fullmatch(r"\w+\((.*)\)", part)):
            part = m.group(1)
        hits += [n for n in names if part == n or part.startswith(n + "_")]
    return hits[-1] if hits else "other"


def stage_times(fn, args, kwargs, names, trace_dir) -> dict:
    """Device time (ms) per named scope from one profiler window around
    ``fn(*args, **kwargs)``.

    Each device event is matched to an HLO instruction of the compiled
    program by its kernel name or a stat value, and that instruction's
    ``op_name`` metadata gives its scope (``scope_of``).  An event whose
    instruction is in no scope goes to "other"; one that matches no
    instruction goes to "unattributed", whose share of the window is
    returned too, so a change in what the attribution can read shows up
    as a number."""
    import jax
    from jax.profiler import ProfileData

    def norm(name):  # kernel names spell HLO's "fusion.8" as "fusion_8"
        return re.sub(r"[.\-]", "_", name)

    compiled = fn.lower(*args, **kwargs).compile()
    op_names = {norm(k): v for k, v in re.findall(
        r"%?([\w.\-]+) = [^\n]*?metadata=\{[^}]*op_name=\"([^\"]+)\"",
        compiled.as_text())}
    jax.block_until_ready(fn(*args, **kwargs))
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn(*args, **kwargs))
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    totals = {n: 0.0 for n in (*names, "other", "unattributed")}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                keys = [ev.name] + [str(v) for _, v in ev.stats]
                op_name = next((op_names[norm(k)] for k in keys
                                if norm(k) in op_names), None)
                scope = ("unattributed" if op_name is None
                         else scope_of(op_name, names))
                totals[scope] += ev.duration_ns / 1e6
    window = sum(totals.values())
    totals["unattributed_share"] = (totals["unattributed"] / window
                                    if window else 0.0)
    return totals


def phase_detect(seed: int, sizes=((1080, 1920), (768, 1020)), n_frames=8,
                 n_oracle=4, profile_dir: str | None = None):
    """detect_batch (production 3-window sweep, both dictionaries) vs the
    NumPy oracle and the renderer's truth."""
    import jax
    import jax.numpy as jnp

    from arslam.config import DetectConfig
    from arslam.detect.device_detect import detect_batch, params_from_config
    from arslam.detect.reference import detect_markers

    checks, times, extra = Checks(), {}, {}
    dcfg = DetectConfig()
    params = params_from_config(dcfg)
    oracle_left = n_oracle
    for si, (h, w) in enumerate(sizes):
        tag = f"{w}x{h}"
        t0 = time.perf_counter()
        frames = render_frames(seed + si, n_frames, h, w)
        batch = jnp.asarray(np.stack([f[0] for f in frames]))
        times[f"{tag}_render"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(detect_batch(batch, params=params,
                                           dict_names=DICTS))
        times[f"{tag}_compile+run"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(detect_batch(batch, params=params,
                                                 dict_names=DICTS))
        times[f"{tag}_run"] = time.perf_counter() - t0
        dists, equal, oracle_false = [], True, 0
        missed = false = 0
        for i, (img, truth) in enumerate(frames):
            found = detections(out, i)
            m, f = truth_misses(found, truth)
            missed, false = missed + m, false + f
            # oracle on the first frames of each size, split between sizes
            if i < -(-n_oracle // len(sizes)) and oracle_left > 0:
                oracle_left -= 1
                t0 = time.perf_counter()
                ref = {(d.dict_name, d.marker_id): d.corners
                       for d in detect_markers(
                           img, dict_names=DICTS,
                           win_sizes=dcfg.adaptive_thresh_win_sizes)}
                real = {(n, m) for n, m, _ in truth}
                oracle_false += len(set(ref) - real)
                ref = {k: v for k, v in ref.items() if k in real}
                times[f"{tag}_oracle"] = (times.get(f"{tag}_oracle", 0.0)
                                          + time.perf_counter() - t0)
                same, d = compare_detections(found, ref)
                equal &= same
                dists += d
        checks.add(f"{tag}_truth_missed", missed,
                   f"0 markers >= {MIN_FOUND_SIDE_PX:g} px", missed == 0)
        checks.add(f"{tag}_truth_false_ids", false, "0", false == 0)
        extra[f"{tag}_markers"] = sum(len(f[1]) for f in frames)
        if dists:
            checks.add(f"{tag}_oracle_ids_equal", equal, "True", equal)
            for stat, q, bound in (("median", 50, CORNER_MEDIAN_PX),
                                   ("p95", 95, CORNER_P95_PX),
                                   ("max", 100, CORNER_MAX_PX)):
                v = float(np.percentile(dists, q))
                checks.add(f"{tag}_oracle_corner_{stat}_px", v,
                           f"<= {bound}", v <= bound)
            extra[f"{tag}_oracle_false_ids"] = oracle_false
        extra[f"{tag}_frames_per_s"] = n_frames / times[f"{tag}_run"]
        if profile_dir and si == 0:
            stages = ("detect_threshold", "detect_decimate", "detect_ccl",
                      "detect_topk", "detect_extract", "detect_compact",
                      "detect_refine", "detect_decode")
            extra[f"{tag}_stage_device_ms"] = stage_times(
                detect_batch, (batch,),
                {"params": params, "dict_names": DICTS}, stages,
                os.path.join(profile_dir, "detect_trace"))
    return checks, times, extra


# ---- images in, map.yaml out --------------------------------------------

def make_scene(seed: int, n_tags: int, n_caps: int, n_loc: int,
               image_size, focal: float):
    """Scene geometry from make_synthetic_map, tags drawn from both
    dictionaries; every (n_caps + n_loc)/n_loc-th capture is held out for
    localization."""
    from arslam.detect.dictionaries import get_dictionary
    from arslam.utils.synthetic import make_synthetic_map

    from scipy.spatial.transform import Rotation

    _, truth = make_synthetic_map(n_tags=n_tags, n_caps=n_caps + n_loc,
                                  focal=focal, image_size=image_size,
                                  seed=seed)
    # a printed tag's local z points into its surface, away from a camera
    # that sees it unmirrored: turn the generator's +z-facing tags over
    rot = Rotation.from_rotvec(truth["tag_poses"][:, 3:6])
    truth["tag_poses"][:, 3:6] = (rot * Rotation.from_euler(
        "x", np.pi)).as_rotvec()
    pool = [(n, i) for n in DICTS for i in range(get_dictionary(n).n_markers)]
    pick = np.random.default_rng(seed).permutation(len(pool))[:n_tags]
    markers = [pool[i] for i in pick]
    every = (n_caps + n_loc) // n_loc
    held = [c for c in range(n_caps + n_loc) if c % every == every // 2]
    held = held[:n_loc]
    mapped = [c for c in range(n_caps + n_loc) if c not in held]
    return truth, markers, mapped, held


def write_captures(truth, markers, caps, image_size, out_dir) -> list[str]:
    from arslam.pipeline.ingest import write_pgm
    from arslam.utils.synthetic import render_capture

    paths = []
    for c in caps:
        img = render_capture(truth["cap_poses"][c], truth["tag_poses"],
                             markers, truth["camera"], image_size,
                             ARUCO_SIZE)
        path = os.path.join(out_dir, f"cap_{c:04d}.pgm")
        write_pgm(path, img)
        paths.append(path)
    return paths


def _rotvec_to_matrix(v):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(v).as_matrix()


def map_figures(store, truth, markers, focal: float, held=()) -> dict:
    """Reprojection RMSE of the map's own observations (NumPy projection),
    focal error, tag-position ATE after a rigid alignment to the truth,
    and each held-out capture's pose error in the aligned frame."""
    from arslam.utils.ate import umeyama_alignment
    from arslam.utils.synthetic import _project_np

    cam = np.asarray(store.camera.params, float)
    sq, n = 0.0, 0
    for b in store.blocks:
        uv = _project_np(cam, store.captures[b.cap_idx].inv_pose,
                         store.arucos[b.tag_idx].pose, ARUCO_SIZE)
        if uv is None:
            sq, n = np.inf, n + 8
            continue
        sq += float(np.sum((uv - b.corners) ** 2))
        n += 8
    names = {f"aruco_{d}_{i}": t for t, (d, i) in enumerate(markers)}
    tags = [a for a in store.arucos if a.id in names]
    out = {
        "rmse_px": float(np.sqrt(sq / n)) if n else np.inf,
        "focal": float(cam[0]),
        "focal_rel_err": float(abs(cam[0] - focal) / focal),
        "captures": len(store.captures),
        "tags": len(tags),
        "tag_ate_m": np.inf,
    }
    if len(tags) < 3:  # nothing to align: every figure below fails
        if held:
            out.update(loc_pos_err_m_max=np.inf, loc_rot_err_deg_max=np.inf)
        return out
    got = np.stack([a.pose[:3] for a in tags])
    want = np.stack([truth["tag_poses"][names[a.id]][:3] for a in tags])
    _, rot, shift = umeyama_alignment(got, want, with_scale=False)
    aligned = got @ rot.T + shift
    out["tag_ate_m"] = float(np.sqrt(np.mean(np.sum((aligned - want) ** 2,
                                                    axis=1))))
    pos_err, rot_err = [], []
    for c in held:
        idx = store.capture_map.get(f"cap_{c:04d}")
        if idx is None:  # not localized
            pos_err.append(np.inf)
            rot_err.append(np.inf)
            continue
        cap = store.captures[idx]
        # camera center p = -t_inv; world->camera rotation R_inv
        center = rot @ -cap.inv_pose[:3] + shift
        pos_err.append(float(np.linalg.norm(
            center + truth["cap_poses"][c][:3])))
        r_map = _rotvec_to_matrix(cap.inv_pose[3:])
        r_true = _rotvec_to_matrix(truth["cap_poses"][c][3:])
        rel = r_map.T @ r_true @ rot
        rot_err.append(float(np.degrees(np.arccos(np.clip(
            (np.trace(rel) - 1.0) / 2.0, -1.0, 1.0)))))
    if held:
        out["loc_pos_err_m_max"] = max(pos_err)
        out["loc_rot_err_deg_max"] = max(rot_err)
    return out


def check_map(figs: dict, checks: Checks, label: str):
    checks.add(f"{label}_rmse_px", figs["rmse_px"], f"< {MAP_RMSE_PX}",
               figs["rmse_px"] < MAP_RMSE_PX)
    checks.add(f"{label}_focal_rel_err", figs["focal_rel_err"],
               f"< {FOCAL_REL}", figs["focal_rel_err"] < FOCAL_REL)
    checks.add(f"{label}_tag_ate_m", figs["tag_ate_m"], f"< {TAG_ATE_M}",
               figs["tag_ate_m"] < TAG_ATE_M)
    if "loc_pos_err_m_max" in figs:
        checks.add(f"{label}_loc_pos_err_m", figs["loc_pos_err_m_max"],
                   f"< {LOC_POS_M}", figs["loc_pos_err_m_max"] < LOC_POS_M)
        checks.add(f"{label}_loc_rot_err_deg", figs["loc_rot_err_deg_max"],
                   f"< {LOC_ROT_DEG}",
                   figs["loc_rot_err_deg_max"] < LOC_ROT_DEG)


def phase_map(seed: int, work_dir: str, n_tags=64, n_caps=48, n_loc=8,
              image_size=(1920, 1080), focal=3000.0):
    """``arslam map`` on rendered captures, ``arslam localize`` of held-out
    renders against the map, and the same captures through the serve
    pipeline — each checked against the scene's truth."""
    from arslam import cli
    from arslam.graph import MapStore, load_yaml
    from arslam.pipeline.engine import ArSlamEngine
    from arslam.pipeline.stream import StreamPipeline

    checks, times, extra = Checks(), {}, {}
    t0 = time.perf_counter()
    truth, markers, mapped, held = make_scene(seed, n_tags, n_caps, n_loc,
                                              image_size, focal)
    os.makedirs(work_dir, exist_ok=True)
    map_files = write_captures(truth, markers, mapped, image_size, work_dir)
    loc_files = write_captures(truth, markers, held, image_size, work_dir)
    times["render"] = time.perf_counter() - t0

    map_yaml = os.path.join(work_dir, "map.yaml")
    loc_yaml = os.path.join(work_dir, "localize.yaml")
    t0 = time.perf_counter()
    rc = cli.main(["map", *map_files, "-o", map_yaml])
    times["cli_map"] = time.perf_counter() - t0
    checks.add("cli_map_rc", rc, "0", rc == 0)
    t0 = time.perf_counter()
    rc = cli.main(["localize", map_yaml, *loc_files, "-o", loc_yaml])
    times["cli_localize"] = time.perf_counter() - t0
    checks.add("cli_localize_rc", rc, "0", rc == 0)

    store = MapStore()
    load_yaml(store, loc_yaml)
    figs = map_figures(store, truth, markers, focal, held)
    extra["cli"] = figs
    check_map(figs, checks, "map")

    t0 = time.perf_counter()
    engine = ArSlamEngine()
    pipe = StreamPipeline(engine)
    try:
        pipe.submit(map_files)
        pipe.drain()
    finally:
        pipe.close()
        engine.close()
    times["serve_pipeline"] = time.perf_counter() - t0
    figs = map_figures(engine.store, truth, markers, focal)
    extra["serve"] = figs
    check_map(figs, checks, "serve")
    return checks, times, extra


def resolve_from_detections(loc_yaml: str, held_uids, config=None) -> object:
    """Re-solve a map from scratch from the detections a localize.yaml
    holds (mapped captures, then the held-out ones localized against it):
    the solver half of ``arslam map`` + ``arslam localize`` without
    re-running detection."""
    from arslam.config import ArSlamConfig
    from arslam.graph import MapStore, load_yaml
    from arslam.solve import localize_many, solve_batch

    config = config or ArSlamConfig()
    src = MapStore()
    load_yaml(src, loc_yaml)
    store = MapStore(initial_focal=config.camera.initial_focal)

    def add(cap):
        dets = [(src.arucos[src.blocks[b].tag_idx].id, src.blocks[b].corners)
                for b in cap.blocks]
        store.add_detections(cap.uid, dets, src.camera.size, cap.img_fn)

    held_uids = set(held_uids)
    for cap in src.captures:
        if cap.uid not in held_uids:
            add(cap)
    solve_batch(store, config)
    first = store.next_capture_index
    for cap in src.captures:
        if cap.uid in held_uids:
            add(cap)
    localize_many(store, first, config)
    return store


# ---- the solver at deployment size ---------------------------------------

def solver_problem(n_tags: int, n_caps: int, seed: int = 0):
    from bench import build_problem

    return build_problem(n_tags, n_caps, seed=seed)


def solve_args(arrs, cap_poses, tag_poses, dtype, device=None):
    import jax
    import jax.numpy as jnp

    host = (arrs.camera.astype(dtype), cap_poses.astype(dtype),
            tag_poses.astype(dtype), arrs.cap_idx, arrs.tag_idx,
            arrs.corners.astype(dtype), arrs.block_mask, np.asarray(True),
            arrs.cap_mask, arrs.tag_mask)
    return tuple(jax.device_put(jnp.asarray(x), device) for x in host)


def lm_config(n_iters: int, linear_solver="dense", cg_iters=25):
    from arslam.solve.lm import LMConfig

    return LMConfig(max_iterations=n_iters, function_tolerance=0.0,
                    parameter_tolerance=0.0, linear_solver=linear_solver,
                    cg_max_iterations=cg_iters)


def rmse_of(cost: float, n_blocks: int) -> float:
    return float(np.sqrt(2.0 * cost / (8 * n_blocks)))


def run_lm(arrs, cap_poses, tag_poses, config, dtype=np.float32,
           device=None, memory: bool = False):
    """Compile and run lm_solve once; returns (info, caps, times, mem)."""
    import jax

    from bench import solver_layout
    from arslam.solve.lm import lm_solve

    args = solve_args(arrs, cap_poses, tag_poses, dtype, device)
    kw = dict(aruco_size=ARUCO_SIZE, config=config,
              **solver_layout(arrs, config.linear_solver))
    t0 = time.perf_counter()
    compiled = lm_solve.lower(*args, **kw).compile()
    t_compile = time.perf_counter() - t0
    mem = None
    if memory:
        ma = compiled.memory_analysis()
        mem = {k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}
    t0 = time.perf_counter()
    _, caps, _, info = jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    info = {k: float(v) for k, v in info.items()}
    return info, np.asarray(caps), {"compile": t_compile, "run": t_run}, mem


def phase_dense(n_tags=500, n_caps=200, n_iters=32):
    """Dense-Schur LM on the card (f32) vs the same solver in f64 on the
    host CPU device."""
    import jax

    checks, times, extra = Checks(), {}, {}
    t0 = time.perf_counter()
    arrs, cap_poses, tag_poses = solver_problem(n_tags, n_caps)
    times["generate"] = time.perf_counter() - t0
    config = lm_config(n_iters)
    info, _, t, _ = run_lm(arrs, cap_poses, tag_poses, config)
    times.update({f"device_{k}": v for k, v in t.items()})
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        ref, _, t, _ = run_lm(arrs, cap_poses, tag_poses, config,
                              dtype=np.float64, device=cpu)
    times.update({f"cpu_f64_{k}": v for k, v in t.items()})
    rel = abs(info["cost"] - ref["cost"]) / ref["cost"]
    checks.add("cost_rel_vs_cpu_f64", rel, f"<= {DENSE_COST_REL}",
               rel <= DENSE_COST_REL)
    rmse = rmse_of(info["cost"], int(arrs.n_blocks))
    lo, hi = RMSE_FLOOR_PX
    checks.add("rmse_px", rmse, f"in [{lo}, {hi}]", lo <= rmse <= hi)
    extra.update(cost=info["cost"], cost_cpu_f64=ref["cost"],
                 initial_cost=info["initial_cost"],
                 iterations=info["iterations"],
                 rmse_cpu_f64=rmse_of(ref["cost"], int(arrs.n_blocks)),
                 blocks=int(arrs.n_blocks))
    return checks, times, extra


def phase_cg(n_tags=10000, n_caps=4000, n_iters=25):
    """Implicit-Schur CG LM at the 10k-tag / 4k-capture map, from perturbed
    truth: cost decreases to the noise floor."""
    import jax

    from arslam.utils.ate import ate_rmse

    checks, times, extra = Checks(), {}, {}
    t0 = time.perf_counter()
    arrs, cap_poses, tag_poses = solver_problem(n_tags, n_caps)
    times["generate"] = time.perf_counter() - t0
    info, caps, t, mem = run_lm(arrs, cap_poses, tag_poses,
                                lm_config(n_iters, "cg"), memory=True)
    times.update(t)
    rmse = rmse_of(info["cost"], int(arrs.n_blocks))
    checks.add("cost_decreased", info["cost"] < info["initial_cost"],
               "True", info["cost"] < info["initial_cost"])
    checks.add("rmse_px", rmse, f"<= {CG_RMSE_PX}", rmse <= CG_RMSE_PX)
    n = arrs.n_caps
    ate = ate_rmse(-caps[:n, :3], -np.asarray(arrs.cap_poses[:n, :3]))
    stats = jax.devices()[0].memory_stats() or {}
    extra.update(blocks=int(arrs.n_blocks), cost=info["cost"],
                 initial_cost=info["initial_cost"],
                 iterations=info["iterations"], camera_ate_m=ate,
                 memory_analysis=mem,
                 peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    return checks, times, extra


def phase_demo_cold(n_tags=6, n_caps=3):
    """Cold (first in process) and warm demo-size batch solve: the cost of
    tracing + compiling the wave program, on record."""
    from arslam.config import ArSlamConfig
    from arslam.solve import solve_batch
    from arslam.utils.synthetic import make_synthetic_map

    checks, times = Checks(), {}
    for name in ("cold", "warm"):
        store, _ = make_synthetic_map(n_tags=n_tags, n_caps=n_caps,
                                      noise_px=0.3, seed=0)
        t0 = time.perf_counter()
        out = solve_batch(store, ArSlamConfig())
        times[name] = time.perf_counter() - t0
        checks.add(f"{name}_rmse_px", out["rmse"], "< 1.0", out["rmse"] < 1.0)
    return checks, times, {}


def phase_tf32(n=2048):
    """Does an unpinned float32 matmul run below f32 precision here?"""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    errs = {}
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            got = np.asarray(jax.jit(jnp.matmul)(a, b), np.float64)
        errs[prec] = float(np.abs(got - ref).max() / scale)
    checks = Checks()
    checks.add("highest_rel_err", errs["highest"], "< 1e-5",
               errs["highest"] < 1e-5)
    return checks, {}, {"default_rel_err": errs["default"],
                        "reduced_precision_by_default":
                            errs["default"] > 1e-5}


def phase_numerics(seed: int, work_dir: str, dense_sizes=(500, 200),
                   n_iters=32, focal=3000.0, n_tags=64, n_caps=48, n_loc=8,
                   image_size=(1920, 1080)):
    """The 500-tag recovery and the rendered-map solve again inside
    ``default_matmul_precision("highest")``: whether pinning moves them."""
    import jax

    checks, times, extra = Checks(), {}, {}
    arrs, cap_poses, tag_poses = solver_problem(*dense_sizes)
    truth, markers, _, held_caps = make_scene(seed, n_tags, n_caps, n_loc,
                                              image_size, focal)
    with jax.default_matmul_precision("highest"):
        info, _, t, _ = run_lm(arrs, cap_poses, tag_poses,
                               lm_config(n_iters))
        times.update({f"dense_{k}": v for k, v in t.items()})
        t0 = time.perf_counter()
        store = resolve_from_detections(
            os.path.join(work_dir, "localize.yaml"),
            [f"cap_{c:04d}" for c in held_caps])
        times["map_resolve"] = time.perf_counter() - t0
    rmse = rmse_of(info["cost"], int(arrs.n_blocks))
    lo, hi = RMSE_FLOOR_PX
    checks.add("highest_dense_rmse_px", rmse, f"in [{lo}, {hi}]",
               lo <= rmse <= hi)
    figs = map_figures(store, truth, markers, focal, held_caps)
    check_map(figs, checks, "highest_map")
    extra.update(dense_cost=info["cost"], map=figs)
    return checks, times, extra


# ---- four cards -----------------------------------------------------------

def phase_four_dense(n_tags=500, n_caps=200, n_iters=32, n_devices=4):
    from arslam.parallel import block_mesh, lm_solve_dist

    checks, times, extra = Checks(), {}, {}
    arrs, cap_poses, tag_poses = solver_problem(n_tags, n_caps)
    config = lm_config(n_iters)
    single, _, t, _ = run_lm(arrs, cap_poses, tag_poses, config)
    times.update({f"single_{k}": v for k, v in t.items()})
    dist, t = _run_dist(block_mesh(n_devices), arrs, cap_poses, tag_poses,
                        config)
    times.update(t)
    rel = abs(dist["cost"] - single["cost"]) / single["cost"]
    checks.add("dist_vs_single_cost_rel", rel, f"<= {DIST_DENSE_REL}",
               rel <= DIST_DENSE_REL)
    extra.update(single_cost=single["cost"], dist_cost=dist["cost"])
    return checks, times, extra


def phase_four_cg(n_tags=10000, n_caps=4000, n_iters=25, n_devices=4):
    from arslam.parallel import block_mesh

    checks, times, extra = Checks(), {}, {}
    t0 = time.perf_counter()
    arrs, cap_poses, tag_poses = solver_problem(n_tags, n_caps)
    times["generate"] = time.perf_counter() - t0
    config = lm_config(n_iters, "cg")
    single, _, t, _ = run_lm(arrs, cap_poses, tag_poses, config)
    times.update({f"single_{k}": v for k, v in t.items()})
    dist, t = _run_dist(block_mesh(n_devices), arrs, cap_poses, tag_poses,
                        config)
    times.update(t)
    rel = abs(dist["cost"] - single["cost"]) / single["cost"]
    checks.add("dist_vs_single_cost_rel", rel, f"<= {DIST_CG_REL}",
               rel <= DIST_CG_REL)
    checks.add("dist_cost_decreased", dist["cost"] < dist["initial_cost"],
               "True", dist["cost"] < dist["initial_cost"])
    extra.update(single_cost=single["cost"], dist_cost=dist["cost"],
                 blocks=int(arrs.n_blocks))
    return checks, times, extra


def _run_dist(mesh, arrs, cap_poses, tag_poses, config):
    """lm_solve_dist twice (first call compiles); returns (info, times)."""
    import jax

    from arslam.parallel import lm_solve_dist

    args = (arrs.camera.astype(np.float32), cap_poses.astype(np.float32),
            tag_poses.astype(np.float32), arrs.cap_idx, arrs.tag_idx,
            arrs.corners.astype(np.float32), arrs.block_mask,
            np.asarray(True), arrs.cap_mask, arrs.tag_mask)
    times = {}
    for name in ("dist_compile+run", "dist_run"):
        t0 = time.perf_counter()
        _, _, _, info = jax.block_until_ready(lm_solve_dist(
            mesh, *args, aruco_size=ARUCO_SIZE, config=config))
        times[name] = time.perf_counter() - t0
    return {k: float(v) for k, v in info.items()}, times


def phase_four_detect(seed: int, n_frames=8, size=(1080, 1920),
                      n_devices=4):
    import jax
    import jax.numpy as jnp

    from arslam.config import DetectConfig
    from arslam.detect.device_detect import detect_batch, params_from_config
    from arslam.parallel.detect import detect_batch_sharded, image_mesh

    checks, times = Checks(), {}
    params = params_from_config(DetectConfig())
    frames = render_frames(seed, n_frames, *size)
    batch = np.stack([f[0] for f in frames])
    t0 = time.perf_counter()
    single = jax.block_until_ready(detect_batch(
        jnp.asarray(batch), params=params, dict_names=DICTS))
    times["single"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = jax.block_until_ready(detect_batch_sharded(
        batch, mesh=image_mesh(n_devices), params=params, dict_names=DICTS))
    times["sharded"] = time.perf_counter() - t0
    equal, dists = True, [0.0]
    for i in range(n_frames):
        same, d = compare_detections(detections(sharded, i),
                                     detections(single, i))
        equal &= same
        dists += d
    checks.add("ids_equal", equal, "True", equal)
    checks.add("corner_max_px", max(dists), f"<= {SHARDED_CORNER_MAX_PX}",
               max(dists) <= SHARDED_CORNER_MAX_PX)
    return checks, times, {}


# ---- driver ---------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh paths and their "
                         "single-card comparisons, and no other phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=os.path.join(
                        REPO, "chiprun_out", "smoke_trace"),
                    help="directory for the detection profiler trace")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "arslam")):
        print("chip_smoke: the arslam package is not next to this script",
              file=sys.stderr)
        return 2
    from bench import card_info

    card = card_info()  # before JAX starts
    native = build_native()
    import jax

    from arslam.cli import _enable_compile_cache

    cache = _enable_compile_cache()
    devices = jax.devices()
    print(f"card: {card} | jax {jax.__version__} | devices {len(devices)} "
          f"({devices[0].platform}, {devices[0].device_kind}) | "
          f"pyyaml {_have('yaml')} | pillow {_have('PIL')} | "
          f"native graph {native['graph']} jpeg {native['jpeg']} | "
          f"compile cache {cache}", flush=True)
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    work = tempfile.mkdtemp(prefix="arslam_smoke_")  # rendered captures
    if args.four:
        phases = [
            ("four_dense", lambda: phase_four_dense()),
            ("four_cg", lambda: phase_four_cg()),
            ("four_detect", lambda: phase_four_detect(args.seed)),
        ]
    else:
        phases = [
            ("demo_cold", lambda: phase_demo_cold()),
            ("tf32", lambda: phase_tf32()),
            ("detect", lambda: phase_detect(args.seed,
                                            profile_dir=args.trace_dir)),
            ("map", lambda: phase_map(args.seed, work)),
            ("dense", lambda: phase_dense()),
            ("numerics", lambda: phase_numerics(args.seed, work)),
            ("cg", lambda: phase_cg()),
        ]
    ok = True
    try:
        for name, run in phases:
            t0 = time.perf_counter()
            checks, times, extra = run()
            times["total"] = time.perf_counter() - t0
            report(name, checks, times, extra)
            ok &= checks.ok
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not ok:
        print("chip_smoke: a phase failed its bounds", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
