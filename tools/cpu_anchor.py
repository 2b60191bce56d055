"""One-time external CPU anchor for the BA + localization baselines.

Round 1's ``vs_baseline`` compared the device solver against THIS REPO's own
CPU float64 path — self-referential.  This tool runs an INDEPENDENT
implementation — scipy.optimize.least_squares (Trust Region Reflective,
sparse finite-difference Jacobian, lsmr sub-solver; the closest
pip-installable stand-in for single-thread Ceres, which is not available in
this image) — and reports wall time, iteration count and final cost, so the
repo's numbers can be sanity-anchored in BASELINE.md.

Two modes:
- ``--mode ba`` (default): the 500-tag / 200-capture synthetic BA problem
  (BASELINE config #5).
- ``--mode localize``: pose-only solves with tags + camera FROZEN — the
  independent stand-in for the reference's pose-only Ceres localization
  (ar_slam_util.cpp:888-979).  Runs the demo img4 query against the solved
  demo map AND a synthetic localize corpus, each solved at f64 by scipy and
  compared against the repo's vmapped f32 kernel (solve/localize.py) —
  establishing whether the kernel's rmse is the query's genuine noise
  floor or an f32 deficit (VERDICT r4 weak #2).

The residual model is an independent NumPy/SciPy re-implementation of the
reference projection (ar_slam_util.cpp:131-172: inverse-pose
translate-then-rotate, centered pixels, focal multiply), NOT a call into
arslam kernels.

Usage: python tools/cpu_anchor.py [--mode ba|localize] [--tags 500]
       [--caps 200] [--max-iters 25]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def solve_pose_only_scipy(camera, tag_poses, tag_idx, corners, pose0,
                          aruco_size: float = 0.0635):
    """Independent f64 pose-only solve: 6 unknowns, tags + camera frozen
    (≙ the reference's localizeOne Ceres problem with constant parameter
    blocks, ar_slam_util.cpp:950-972).  NumPy/SciPy residual model only —
    no arslam kernels.

    Args: camera (3,), tag_poses (T, 6), tag_idx (K,), corners (K, 4, 2)
    centered pixels, pose0 (6,) initial inverse capture pose.
    Returns (pose (6,), final_cost, rmse_px_per_component).
    """
    from scipy.optimize import least_squares
    from scipy.spatial.transform import Rotation

    camera = np.asarray(camera, np.float64)
    tag_poses = np.asarray(tag_poses, np.float64)
    tag_idx = np.asarray(tag_idx)
    obs = np.asarray(corners, np.float64)
    dirs = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float)
    corners_local = np.concatenate(
        [0.5 * aruco_size * dirs, np.zeros((4, 1))], axis=1)  # (4, 3)
    r_t = Rotation.from_rotvec(tag_poses[tag_idx, 3:6]).as_matrix()
    p_w = (np.einsum("bij,cj->bci", r_t, corners_local)
           + tag_poses[tag_idx, None, 0:3])  # (K, 4, 3) frozen world pts

    def residuals(pose):
        r_c = Rotation.from_rotvec(pose[3:6]).as_matrix()
        p_c = np.einsum("ij,bcj->bci", r_c, p_w + pose[None, None, 0:3])
        z = np.maximum(np.abs(p_c[..., 2]), 1e-9) * np.sign(
            p_c[..., 2] + 1e-30)
        uv = camera[0] * p_c[..., 0:2] / z[..., None]
        return (uv - obs).reshape(-1)

    res = least_squares(residuals, np.asarray(pose0, np.float64),
                        method="trf", xtol=1e-14, ftol=1e-14, gtol=1e-14)
    rmse = float(np.sqrt(2.0 * res.cost / res.fun.size))
    return res.x, float(res.cost), rmse


def _mode_localize():
    """Anchor the localization kernel: demo img4 + synthetic corpus."""
    import yaml

    import jax.numpy as jnp

    from arslam.config import ArSlamConfig
    from arslam.solve import localize_many, solve_batch
    from arslam.graph import MapStore

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixture = os.path.join(repo, "tests", "fixtures", "demo_detections.yaml")
    data = yaml.safe_load(open(fixture))
    store = MapStore()
    for cap in data["captures"][:3]:
        dets = [(d["id"], np.array(d["corners"]).reshape(4, 2))
                for d in cap["detections"]["4X4_50"]]
        store.add_detections(cap["uid"], dets,
                             (cap["width"], cap["height"]), cap["img_fn"])
    cfg = ArSlamConfig()
    solve_batch(store, cfg, dtype=np.float32)

    first = store.next_capture_index
    cap4 = data["captures"][3]
    dets = [(d["id"], np.array(d["corners"]).reshape(4, 2))
            for d in cap4["detections"]["4X4_50"]]
    store.add_detections(cap4["uid"], dets, (cap4["width"], cap4["height"]),
                         cap4["img_fn"])
    loc = localize_many(store, first, cfg)
    kernel_rmse = float(loc["rmse"])
    query = store.captures[first]
    kernel_pose = np.asarray(query.inv_pose, np.float64).copy()

    # scipy f64 re-solve of the IDENTICAL query (same frozen map, same
    # map-known blocks), seeded from the kernel's answer AND from a crude
    # perturbation — both must land on the same optimum for the anchor to
    # certify a basin, not a saddle
    tag_poses = np.stack([t.pose for t in store.arucos])
    q_blocks = [store.blocks[bh] for bh in query.blocks
                if any(store.blocks[b2].cap_idx < first
                       for b2 in store.arucos[store.blocks[bh].tag_idx]
                       .blocks)]
    ti = np.array([b.tag_idx for b in q_blocks])
    crn = np.stack([b.corners for b in q_blocks])
    pose_a, cost_a, rmse_a = solve_pose_only_scipy(
        store.camera.params, tag_poses, ti, crn, kernel_pose)
    pose_b, _, rmse_b = solve_pose_only_scipy(
        store.camera.params, tag_poses, ti, crn,
        kernel_pose + np.array([0.05, -0.05, 0.1, 0.02, -0.02, 0.03]))

    # synthetic corpus: hold out queries from a synthetic map, localize
    # with the kernel (f32) and scipy (f64)
    from arslam.utils.synthetic import make_synthetic_map

    s_store, truth = make_synthetic_map(n_tags=40, n_caps=24, seed=7,
                                        noise_px=0.3)
    for cap in s_store.captures:
        cap.inv_pose[:] = truth["cap_poses"][int(cap.uid.split("_")[1])]
    for tag in s_store.arucos:
        tag.pose[:] = truth["tag_poses"][int(tag.id.split("_")[-1])]
    s_store.camera.params[:] = truth["camera"]
    s_first = 16  # captures 16..23 are queries against the frozen truth map
    s_loc = localize_many(s_store, s_first, cfg, dtype=np.float32)
    s_tags = np.stack([t.pose for t in s_store.arucos])
    deltas, rmse_s = [], []
    for cap in s_store.captures[s_first:]:
        blocks = [s_store.blocks[bh] for bh in cap.blocks]
        s_ti = np.array([b.tag_idx for b in blocks])
        s_crn = np.stack([b.corners for b in blocks])
        kp = np.asarray(cap.inv_pose, np.float64)
        sp, _, sr = solve_pose_only_scipy(s_store.camera.params, s_tags,
                                          s_ti, s_crn, kp)
        deltas.append(float(np.abs(kp - sp).max()))
        rmse_s.append(sr)
    out = {
        "tool": "scipy.least_squares trf f64 pose-only (frozen tags+camera)",
        "demo_img4": {
            "kernel_rmse_px": round(kernel_rmse, 4),
            "anchor_rmse_px": round(rmse_a, 4),
            "anchor_rmse_perturbed_seed_px": round(rmse_b, 4),
            "pose_delta_max": float(np.abs(kernel_pose - pose_a).max()),
            "seed_consistent": bool(np.abs(pose_a - pose_b).max() < 1e-6),
            "map_known_blocks": len(q_blocks),
        },
        "synthetic_corpus": {
            "queries": len(rmse_s),
            "kernel_rmse_px": round(float(s_loc["rmse"]), 4),
            "anchor_rmse_px_mean": round(float(np.mean(rmse_s)), 4),
            "pose_delta_max": round(float(np.max(deltas)), 8),
        },
    }
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["ba", "localize"], default="ba")
    ap.add_argument("--tags", type=int, default=500)
    ap.add_argument("--caps", type=int, default=200)
    ap.add_argument("--max-iters", type=int, default=25)
    args = ap.parse_args()

    if args.mode == "localize":
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        _mode_localize()
        return

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import build_problem

    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix
    from scipy.spatial.transform import Rotation

    arrs, cap_poses, tag_poses = build_problem(args.tags, args.caps,
                                               dtype=np.float64)
    m = np.asarray(arrs.block_mask)
    ci = np.asarray(arrs.cap_idx)[m]
    ti = np.asarray(arrs.tag_idx)[m]
    obs = np.asarray(arrs.corners)[m]  # (B, 4, 2) centered pixels
    b = ci.shape[0]
    n_caps = cap_poses.shape[0]
    n_tags = tag_poses.shape[0]
    aruco = 0.0635

    dirs = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float)
    corners_local = np.concatenate(
        [0.5 * aruco * dirs, np.zeros((4, 1))], axis=1)  # (4, 3)

    def unpack(x):
        cam = x[0]
        caps = x[1:1 + 6 * n_caps].reshape(n_caps, 6)
        tags = x[1 + 6 * n_caps:].reshape(n_tags, 6)
        return cam, caps, tags

    def residuals(x):
        focal, caps, tags = unpack(x)
        r_t = Rotation.from_rotvec(tags[ti, 3:6]).as_matrix()  # (B,3,3)
        p_w = np.einsum("bij,cj->bci", r_t, corners_local) + tags[ti, None, 0:3]
        r_c = Rotation.from_rotvec(caps[ci, 3:6]).as_matrix()
        p_c = np.einsum("bij,bcj->bci", r_c, p_w + caps[ci, None, 0:3])
        z = np.maximum(np.abs(p_c[..., 2]), 1e-9) * np.sign(p_c[..., 2] + 1e-30)
        uv = focal * p_c[..., 0:2] / z[..., None]
        return (uv - obs).reshape(-1)

    # parameter vector: [focal, cap poses, tag poses] (l1, l2 are disabled
    # in the reference model, ar_slam_util.cpp:164-171 — omitted here)
    x0 = np.concatenate([
        np.asarray(arrs.camera[:1], np.float64),
        np.asarray(cap_poses, np.float64).reshape(-1),
        np.asarray(tag_poses, np.float64).reshape(-1),
    ])

    # block-sparse Jacobian pattern: 8 residuals x (focal + its capture's 6
    # + its tag's 6)
    n_par = x0.size
    pat = lil_matrix((8 * b, n_par), dtype=bool)
    rows = np.arange(8 * b).reshape(b, 8)
    for blk in range(b):
        pat[rows[blk], 0] = True
        pat[rows[blk], 1 + 6 * ci[blk]: 1 + 6 * ci[blk] + 6] = True
        c0 = 1 + 6 * n_caps + 6 * ti[blk]
        pat[rows[blk], c0:c0 + 6] = True

    r0 = residuals(x0)
    cost0 = 0.5 * float(r0 @ r0)
    t0 = time.time()
    res = least_squares(
        residuals, x0, jac_sparsity=pat, method="trf", tr_solver="lsmr",
        max_nfev=args.max_iters * 40, verbose=0,
    )
    wall = time.time() - t0
    iters = int(res.njev)
    out = {
        "tool": "scipy.least_squares trf+lsmr (sparse 2-point jac)",
        "blocks": int(b),
        "params": int(n_par),
        "initial_cost": cost0,
        "final_cost": float(res.cost),
        "final_rmse_px": float(np.sqrt(2.0 * res.cost / r0.size)),
        "wall_s": round(wall, 2),
        "jacobian_evals": iters,
        "nfev": int(res.nfev),
        "iters_per_s": round(iters / wall, 4),
        "status": int(res.status),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
