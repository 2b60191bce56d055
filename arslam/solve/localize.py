"""Map-based localization: pose-only solves against a frozen map.

≙ ``ArSlamSolver::localizeMany`` / ``localizeOne``
(ar_slam_util.cpp:888-979): each query capture is seeded from a block whose
tag is shared with a map capture, then optimized alone with tag poses and
camera intrinsics constant.

Because the map is frozen, every query is an independent 6-unknown problem —
so unlike the reference (which re-builds a ceres problem per query), all
queries solve simultaneously in ONE device call: a vmapped dense 6x6 LM.
This is the `captures localized / s` headline path.
"""

from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from arslam.core.projection import block_residual
from arslam.core.seeding import seed_capture_pose
from arslam.graph.arrays import bucket_size
from arslam.graph.store import MapStore
from arslam.solve.lm import LMConfig

_HP = jax.lax.Precision.HIGHEST  # the pose normal equations run at full f32

logger = logging.getLogger(__name__)


@partial(jax.jit, static_argnames=("aruco_size", "config", "seed_mode"))
def localize_kernel(
    camera,
    tag_poses,
    q_tag_idx,
    q_corners,
    q_block_mask,
    q_seed_slot,
    *,
    aruco_size: float,
    config: LMConfig,
    seed_mode: str = "hybrid",
):
    """Vmapped pose-only LM.

    Args:
      camera: (3,) frozen intrinsics.
      tag_poses: (T, 6) frozen map tag poses.
      q_tag_idx: (Q, K) tag index per query block (padded).
      q_corners: (Q, K, 4, 2) observed corners.
      q_block_mask: (Q, K) bool.
      q_seed_slot: (Q,) int — which of the K blocks seeds the pose.

    Returns:
      ((Q, 6) optimized inverse capture poses, (Q,) final costs,
       (Q,) int32 iteration counts).
    """

    def residual_fn(pose, tag_idx, corners, mask):
        def one(t, crn):
            return block_residual(camera, pose, tag_poses[t], crn, aruco_size,
                                  config.enable_distortion)

        r = jax.vmap(one)(tag_idx, corners)  # (K, 8)
        return jnp.where(mask[:, None] > 0, r, 0.0).reshape(-1)  # (K*8,)

    def solve_one(tag_idx, corners, mask, seed_slot):
        maskf = mask.astype(camera.dtype)
        seed_tag = tag_poses[tag_idx[seed_slot]]
        pose0 = seed_capture_pose(
            corners[seed_slot], camera, seed_tag, aruco_size, mode=seed_mode
        )

        def cost_of(pose):
            r = residual_fn(pose, tag_idx, corners, maskf)
            return 0.5 * jnp.sum(r * r)

        def body(state):
            pose, lam, nu, cost, it, conv = state
            r = residual_fn(pose, tag_idx, corners, maskf)
            j = jax.jacfwd(residual_fn)(pose, tag_idx, corners, maskf)  # (K8,6)
            h = jnp.matmul(j.T, j, precision=_HP)
            g = jnp.matmul(j.T, r, precision=_HP)
            d = jnp.clip(jnp.diagonal(h), 1e-6, 1e32)
            step = -jnp.linalg.solve(h + lam * jnp.diag(d), g)
            new_pose = pose + step
            new_cost = cost_of(new_pose)
            model = (-jnp.dot(g, step, precision=_HP)
                     - 0.5 * jnp.sum(jnp.matmul(j, step, precision=_HP) ** 2))
            rho = (cost - new_cost) / jnp.maximum(model, 1e-30)
            accept = rho > config.min_relative_decrease
            lam_acc = jnp.clip(
                lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                config.min_lambda, config.max_lambda,
            )
            lam_rej = jnp.minimum(lam * nu, config.max_lambda)
            # full convergence battery, same as the main driver
            # (solve/lm.py lm_core): function tolerance OR parameter
            # tolerance on accepted steps, stall-lambda exit on rejected
            # ones — a query that keeps rejecting steps must not burn the
            # whole iteration budget (and, vmapped, pin every OTHER query
            # at the slowest one's count).
            f_conv = jnp.abs(cost - new_cost) <= config.function_tolerance * cost
            step_norm = jnp.sqrt(jnp.sum(step * step))
            x_norm = jnp.sqrt(jnp.sum(pose * pose))
            p_conv = step_norm <= config.parameter_tolerance * (
                x_norm + config.parameter_tolerance
            )
            stalled = ~accept & (lam >= config.stall_lambda)
            conv = (accept & (f_conv | p_conv)) | stalled
            return (
                jnp.where(accept, new_pose, pose),
                jnp.where(accept, lam_acc, lam_rej),
                jnp.where(accept, 2.0, nu * 2.0),
                jnp.where(accept, new_cost, cost),
                it + 1,
                conv,
            )

        def cond(state):
            return (state[4] < config.max_iterations) & ~state[5]

        init = (
            pose0,
            jnp.asarray(config.initial_lambda, camera.dtype),
            jnp.asarray(2.0, camera.dtype),
            cost_of(pose0),
            jnp.asarray(0, jnp.int32),
            # padded queries (all-false mask) start converged — their zero
            # residuals can never trigger accept, so they would otherwise
            # pin the batched while_loop at max_iterations
            ~jnp.any(mask),
        )
        pose, _, _, cost, it, _ = jax.lax.while_loop(cond, body, init)
        return pose, cost, it

    return jax.vmap(solve_one)(q_tag_idx, q_corners, q_block_mask, q_seed_slot)


def localize_many(store: MapStore, first_loc_cap_idx: int, config=None,
                  dtype=None) -> dict:
    """Localize every capture with index >= first_loc_cap_idx against the
    frozen map built from earlier captures.

    Mutates the query captures' poses in the store.  Returns a summary with
    per-capture status ("localized" / "disconnected").
    """
    from arslam.config import ArSlamConfig
    from arslam.solve.batch import _default_dtype, _lm_config

    config = config or ArSlamConfig()
    dtype = dtype or _default_dtype(config)
    def tag_in_map(tag) -> bool:
        return any(store.blocks[tbh].cap_idx < first_loc_cap_idx
                   for tbh in tag.blocks)

    # parity switch: the reference's localizeOne adds ALL of the query's
    # blocks with tag poses constant — including tags absent from the map,
    # whose never-initialized zero poses poison the pose-only solve
    # (ar_slam_util.cpp:950-972).  Default (False) uses only map-known tags
    # (deliberate divergence, README); --parity restores the reference
    # behavior exactly for A/B runs.
    include_unknown = bool(getattr(config.solver, "localize_unknown_tags",
                                   False))
    queries = []
    status = {}
    for cap in store.captures[first_loc_cap_idx:]:
        # find a block whose tag is shared with a map capture
        # (≙ ar_slam_util.cpp:911-927); the SEED block must be map-known
        # either way (≙ the initCapturePose source block)
        seed_block = None
        map_blocks = []
        for bh in cap.blocks:
            tag = store.arucos[store.blocks[bh].tag_idx]
            if tag_in_map(tag):
                map_blocks.append(bh)
                if seed_block is None:
                    seed_block = bh
            elif include_unknown:
                map_blocks.append(bh)
        if seed_block is None:
            logger.warning(
                "Cannot find connected ar tags for capture %d", cap.index
            )
            status[cap.uid] = "disconnected"
            continue
        queries.append((cap, seed_block, map_blocks))
        status[cap.uid] = "localized"

    if not queries:
        return {"status": status, "localized": 0}

    k_pad = bucket_size(max(len(mb) for _, _, mb in queries), floor=4)
    t_pad = bucket_size(max(len(store.arucos), 1))
    q = len(queries)
    # bucket the query axis too: each distinct count is a fresh compile
    # (padded queries have all-false masks; their solves are discarded)
    q_pad = bucket_size(q, floor=4)
    q_tag_idx = np.zeros((q_pad, k_pad), dtype=np.int32)
    q_corners = np.zeros((q_pad, k_pad, 4, 2), dtype=dtype)
    q_mask = np.zeros((q_pad, k_pad), dtype=bool)
    q_seed = np.zeros(q_pad, dtype=np.int32)
    for qi, (cap, seed_block, map_blocks) in enumerate(queries):
        for ki, bh in enumerate(map_blocks):
            block = store.blocks[bh]
            q_tag_idx[qi, ki] = block.tag_idx
            q_corners[qi, ki] = block.corners
            q_mask[qi, ki] = True
            if bh == seed_block:
                q_seed[qi] = ki

    tag_poses = np.zeros((t_pad, 6), dtype=dtype)
    for tag in store.arucos:
        tag_poses[tag.index] = tag.pose

    poses, costs, iters = localize_kernel(
        jnp.asarray(store.camera.params, dtype=dtype),
        jnp.asarray(tag_poses),
        jnp.asarray(q_tag_idx),
        jnp.asarray(q_corners),
        jnp.asarray(q_mask),
        jnp.asarray(q_seed),
        aruco_size=config.aruco_size,
        config=_lm_config(config.solver, config.camera),
        seed_mode=config.solver.seed_mode,
    )
    poses = np.asarray(poses)[:q]
    costs = np.asarray(costs)[:q]
    iters = np.asarray(iters)[:q]
    for qi, (cap, _, _) in enumerate(queries):
        cap.inv_pose[:] = poses[qi]
    n_blocks = int(q_mask.sum())
    return {
        "status": status,
        "localized": len(queries),
        "cost": float(costs.sum()),
        "rmse": float(np.sqrt(2.0 * costs.sum() / (8 * n_blocks))),
        "iterations": {cap.uid: int(iters[qi])
                       for qi, (cap, _, _) in enumerate(queries)},
    }
