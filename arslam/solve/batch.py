"""Host-side solve drivers: batch BFS mapping and incremental extension.

Replicates the reference's solve strategies on top of the jitted LM core:

- ``solve`` ≙ ``ArSlamSolver::solve`` (ar_slam_util.cpp:744-866): pick the
  capture with the most blocks, BFS the capture–tag graph, and after adding
  each capture re-run full LM on the active subproblem.  Device-side state
  (poses) stays resident between waves; each wave is ONE device call (seed
  prologue + LM while_loop fused in a single jit).
- ``solve_incremental`` ≙ ``ArSlamSolver::solveIncremental``
  (ar_slam_util.cpp:629-742): drain the unsolved pool by repeated sweeps,
  attaching any capture that shares an initialized tag.

Shapes are padded to power-of-two buckets, so the wave jit compiles
O(log n) times as the map grows.
"""

from __future__ import annotations

import logging
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from arslam.core.seeding import (seed_capture_pose,
                                      seed_capture_pose_multi, seed_tag_pose)
from arslam.graph.arrays import export_arrays, write_back
from arslam.graph.store import MapStore
from arslam.solve.lm import LMConfig, lm_solve

logger = logging.getLogger(__name__)


def apply_wave_seeds_multi(camera, cap_poses, tag_poses, cap_idx, tag_idx,
                           corners, seed_caps, seed_blocks, wave_tags,
                           wave_rows, wave_mask, anchor_rows, anchor_mask,
                           aruco_size, seed_mode):
    """Seed a SEQUENCE of waves in one traced scan (wave w seeds its
    capture, then initializes the tags first seen in wave w — through the
    freshly seeded capture, like the per-wave prologue).

    The per-wave tag inits come as (W, S) SLOT TABLES, not (T,) masks: the
    scan body then touches only each wave's <= S new tags.  The earlier
    per-tag form vmapped the seed math over ALL T tags every wave (W*T
    seed evaluations per flush) and its in-scan (T,)-indexed gathers from
    the block/pose tables lowered as tags x blocks / tags x tags
    broadcast-selects — 10-50 GB intermediates at 10k tags / 263k blocks.

    Args:
      seed_caps: (W,) int32 capture index per wave.
      seed_blocks: (W,) int32 seed block row per wave (-1 = keep pose /
        padding wave).
      wave_tags: (W, S) int32 tag indices first seen per wave.
      wave_rows: (W, S) int32 block row seeding each of those tags; the
        block belongs to the wave's capture (lazy tag init through the
        freshly seeded capture, ar_slam_util.cpp:817-824), so the seed
        reads that wave's capture pose.
      wave_mask: (W, S) bool valid-slot mask.
      anchor_rows: (W, Sa) int32 block rows of the wave capture's
        observations of ALREADY-initialized tags — the capture seed
        averages over all of them (seed_capture_pose_multi); parity mode
        passes exactly the single init_block.
      anchor_mask: (W, Sa) bool.
    """
    # block-table gathers hoisted out of the scan ((W, S, ...) — small)
    init_corners = corners[jnp.maximum(wave_rows, 0)]
    anc_corners = corners[jnp.maximum(anchor_rows, 0)]  # (W, Sa, 4, 2)
    anc_tags = tag_idx[jnp.maximum(anchor_rows, 0)]  # (W, Sa)
    t_total = tag_poses.shape[0]

    def body(carry, wave):
        cap_poses, tag_poses = carry
        (seed_cap, seed_block, crn_w, tags_w, mask_w, anc_crn_w,
         anc_tags_w, anc_mask_w) = wave

        def seed_pose(cp):
            anchor_tag_poses = tag_poses[anc_tags_w]  # (Sa, 6)
            pose = seed_capture_pose_multi(
                anc_crn_w, camera, anchor_tag_poses, anc_mask_w,
                aruco_size, mode=seed_mode)
            return cp.at[seed_cap].set(pose)

        cap_poses = jax.lax.cond(seed_block >= 0, seed_pose,
                                 lambda cp: cp, cap_poses)
        # the wave's capture pose — every tag initialized this wave seeds
        # through it (invariant above)
        cap_pose_w = cap_poses[seed_cap]

        def seed_one(blk_corners):
            return seed_tag_pose(blk_corners, camera, cap_pose_w,
                                 aruco_size, mode=seed_mode)

        cand = jax.vmap(seed_one)(crn_w)  # (S, 6)
        # masked row scatter; padding slots target row T -> dropped
        tgt = jnp.where(mask_w, tags_w, t_total)
        tag_poses = tag_poses.at[tgt].set(cand, mode="drop")
        return (cap_poses, tag_poses), None

    (cap_poses, tag_poses), _ = jax.lax.scan(
        body, (cap_poses, tag_poses),
        (seed_caps, seed_blocks, init_corners, wave_tags, wave_mask,
         anc_corners, anc_tags, anchor_mask))
    return cap_poses, tag_poses


def apply_wave_seeds(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
                     seed_cap, seed_block, tag_init_blocks, anchor_rows,
                     anchor_mask, aruco_size, seed_mode):
    """Wave prologue (traceable): optional capture seeding + lazy tag init.

    Args:
      seed_cap: () int32 — capture index to (re)seed.
      seed_block: () int32 — block row to seed it from, or -1 to keep its
        pose (the BFS root keeps whatever pose it has,
        ar_slam_util.cpp:803-807).
      tag_init_blocks: (T,) int32 — per tag, the block row to initialize
        its pose from (through the freshly seeded capture), or -1 to keep.
      anchor_rows: (Sa,) int32 block rows of the capture's observations of
        already-initialized tags (multi-anchor seed; parity passes just the
        init_block).
      anchor_mask: (Sa,) bool.
    Returns (cap_poses, tag_poses) with seeds applied.
    """
    anc_corners = corners[jnp.maximum(anchor_rows, 0)]  # (Sa, 4, 2)
    anc_tags = tag_idx[jnp.maximum(anchor_rows, 0)]  # (Sa,)

    def seed_pose(cp):
        pose = seed_capture_pose_multi(
            anc_corners, camera, tag_poses[anc_tags], anchor_mask,
            aruco_size, mode=seed_mode)
        return cp.at[seed_cap].set(pose)

    cap_poses = jax.lax.cond(
        seed_block >= 0, seed_pose, lambda cp: cp, cap_poses
    )

    # gather corners with clamped indices up front, and read the wave's
    # capture pose ONCE — every tag initialized this wave seeds through the
    # freshly seeded capture (same invariant as apply_wave_seeds_multi;
    # per-tag gathers from the big tables lower as giant broadcasts here)
    safe_init = jnp.maximum(tag_init_blocks, 0)
    init_corners = corners[safe_init]  # (T, 4, 2)
    cap_pose_w = cap_poses[seed_cap]

    def seed_one(blk_corners):
        return seed_tag_pose(blk_corners, camera, cap_pose_w, aruco_size,
                             mode=seed_mode)

    cand = jax.vmap(seed_one)(init_corners)  # (T, 6)
    tag_poses = jnp.where((tag_init_blocks >= 0)[:, None], cand, tag_poses)
    return cap_poses, tag_poses


@partial(jax.jit,
         static_argnames=("aruco_size", "config", "assemble_fn", "seed_mode",
                          "obs_per_tag", "obs_per_cap", "row_slots",
                          "tag_rows", "cap_rows"))
def solve_wave_multi(
    camera,
    cap_poses,
    tag_poses,
    cap_idx,
    tag_idx,
    corners,
    block_mask,
    cam_active,
    cap_active,
    tag_active,
    seed_caps,
    seed_blocks,
    wave_tags,
    wave_rows,
    wave_mask,
    anchor_rows,
    anchor_mask,
    lm_enabled,
    *,
    aruco_size: float,
    config: LMConfig,
    assemble_fn=None,
    seed_mode: str = "hybrid",
    obs_per_tag: int | None = None,
    obs_per_cap: int | None = None,
    row_slots: int | None = None,
    tag_rows: int | None = None,
    cap_rows: int | None = None,
    iter_budget=None,
):
    """A BATCH of solver waves in one device call: the whole accumulated
    seed sequence (lax.scan) followed by at most one LM solve.  With
    solver.optimize_every=k this turns k host→device round trips into
    one."""
    cap_poses, tag_poses = apply_wave_seeds_multi(
        camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
        seed_caps, seed_blocks, wave_tags, wave_rows, wave_mask,
        anchor_rows, anchor_mask, aruco_size, seed_mode,
    )
    return lm_solve(
        camera, cap_poses, tag_poses, cap_idx, tag_idx, corners, block_mask,
        cam_active, cap_active, tag_active,
        aruco_size=aruco_size, config=config, assemble_fn=assemble_fn,
        enabled=lm_enabled, obs_per_tag=obs_per_tag,
        obs_per_cap=obs_per_cap, row_slots=row_slots, tag_rows=tag_rows,
        cap_rows=cap_rows, iter_budget=iter_budget,
    )


def _maybe_calibrate_focal(store: MapStore, config) -> None:
    """Self-calibrate the initial focal from tag homographies unless the
    focal is already trusted (checkpoint restore / previous calibration) or
    parity mode requests the reference's fixed init."""
    if store.camera.focal_calibrated:
        return
    if config.camera.focal_init_mode != "homography":
        return
    from arslam.core.calib import estimate_focal

    focal = estimate_focal(
        (b.corners for b in store.blocks), config.aruco_size
    )
    if focal is not None and np.isfinite(focal) and focal > 10.0:
        logger.info("self-calibrated initial focal: %.1f px", focal)
        store.camera.params[0] = focal
    store.camera.focal_calibrated = True


def _lm_config(cfg, camera_cfg=None) -> LMConfig:
    return LMConfig(
        # static loop bound covers the final polish; per-wave budgets are
        # passed as the TRACED iter_budget (one compiled program for both)
        max_iterations=max(cfg.max_iterations,
                           getattr(cfg, "final_polish_iterations", 0)),
        initial_lambda=cfg.initial_lambda,
        min_lambda=cfg.min_lambda,
        max_lambda=cfg.max_lambda,
        function_tolerance=cfg.function_tolerance,
        parameter_tolerance=cfg.parameter_tolerance,
        gradient_tolerance=getattr(cfg, "gradient_tolerance", 1e-10),
        jacobi_scaling=cfg.jacobi_scaling,
        enable_distortion=bool(getattr(camera_cfg, "enable_distortion",
                                       False)),
        linear_solver=getattr(cfg, "linear_solver", "dense"),
        cg_tolerance=getattr(cfg, "cg_tolerance", 1e-2),
        cg_max_iterations=getattr(cfg, "cg_max_iterations", 100),
        loss=getattr(cfg, "loss", "trivial"),
        loss_scale=getattr(cfg, "loss_scale", 4.0),
    )


class _WaveRunner:
    """Keeps device-resident pose state across waves over one padded export.

    With ``mesh`` set, block tables are partitioned (locality-preserving
    permutation), padded to the mesh size, and sharded on the leading axis;
    each wave then runs the distributed LM (psum-reduced normal equations
    over the device interconnect) instead of the single-device program.  Pose state stays
    replicated on the mesh between waves.
    """

    def __init__(self, store: MapStore, solver_cfg, aruco_size, dtype,
                 assemble_fn=None, mesh=None, camera_cfg=None):
        self.store = store
        self.aruco_size = aruco_size
        self.config = _lm_config(solver_cfg, camera_cfg)
        self.progress = getattr(solver_cfg, "minimizer_progress_to_stdout",
                                False)
        self.seed_mode = getattr(solver_cfg, "seed_mode", "hybrid")
        self.assemble_fn = assemble_fn
        self.mesh = mesh
        arrs = export_arrays(store, dtype=dtype)
        self.arrs = arrs
        self.c_pad = arrs.cap_poses.shape[0]
        self.t_pad = arrs.tag_poses.shape[0]
        b_pad = arrs.block_mask.shape[0]
        # tag-grouped (scatter-free) assembly: static max obs/tag, bucketed
        # so incremental growth re-jits a bounded number of times
        from arslam.graph.arrays import obs_bucket

        max_obs = max((len(t.blocks) for t in store.arucos), default=1)
        self.obs_per_tag = obs_bucket(max_obs)
        max_obs_cap = max((len(c.blocks) for c in store.captures), default=1)
        self.obs_per_cap = obs_bucket(max_obs_cap)
        # CG solves use the ROW-SPLIT slot packing (schur.TagRows): the
        # budget covers the FULL store's observations (waves only activate
        # subsets), bucketed so incremental growth re-jits boundedly
        self.row_slots = self.tag_rows = self.cap_rows = None
        if getattr(solver_cfg, "linear_solver", "dense") == "cg":
            self.row_slots = 8
            need = sum(-(-max(len(t.blocks), 1) // self.row_slots)
                       for t in store.arucos) or 1
            self.tag_rows = obs_bucket(need)
            need_c = sum(-(-max(len(c.blocks), 1) // self.row_slots)
                         for c in store.captures) or 1
            self.cap_rows = obs_bucket(need_c)
        # fixed flush padding: every fused multi-wave dispatch pads its wave
        # axis to the optimize_every bucket and its tag-init slot axis to
        # obs_per_cap, so ONE compiled program serves every flush (variable
        # buckets re-jit per distinct size, and at 10k-tag scale each
        # compile is long); padding waves/slots are no-ops
        from arslam.graph.arrays import bucket_size

        self.w_fixed = bucket_size(
            max(getattr(solver_cfg, "optimize_every", 1), 1), floor=1)
        # block row lookup: store block index -> device row (identity for
        # the single-device path; partition permutation for the mesh path)
        self.row_of_block = np.arange(b_pad, dtype=np.int32)
        if mesh is None:
            self.camera = jnp.asarray(arrs.camera)
            self.cap_poses = jnp.asarray(arrs.cap_poses)
            self.tag_poses = jnp.asarray(arrs.tag_poses)
            self.cap_idx = jnp.asarray(arrs.cap_idx)
            self.tag_idx = jnp.asarray(arrs.tag_idx)
            self.corners = jnp.asarray(arrs.corners)
            self._dist_wave = None
        else:
            from arslam.parallel.dist_lm import (
                TagShardedProblem, make_dist_wave_solver,
            )

            prob = TagShardedProblem(
                mesh, arrs.cap_idx, arrs.tag_idx, arrs.corners,
                arrs.block_mask, self.t_pad,
            )
            self._prob = prob
            self.row_of_block = prob.prep["row_of_block"]
            self.cap_idx = prob.cap_idx
            self.tag_idx = prob.tag_idx
            self.corners = prob.corners
            self.t_new = prob.t_new
            # tag state lives sharded in the RENUMBERED order
            self.tag_poses = prob.put_tags(arrs.tag_poses)
            (self.camera, self.cap_poses) = prob.put_rep(
                arrs.camera, arrs.cap_poses
            )
            self._dist_wave = make_dist_wave_solver(
                mesh, aruco_size=aruco_size, config=self.config,
                seed_mode=self.seed_mode, obs_per_tag=prob.obs_per_tag,
                obs_per_cap=prob.obs_per_cap, row_slots=prob.row_slots,
                shard_rows=prob.shard_rows,
                shard_cap_rows=prob.shard_cap_rows,
            )
        # host-side solver state (store-index order)
        self.active_caps: set[int] = set()
        self.active_blocks = np.zeros_like(arrs.block_mask)
        self.tag_initialized = np.zeros(self.t_pad, dtype=bool)
        self.active_tags = np.zeros(self.t_pad, dtype=bool)
        self.last_info = None
        # accumulated seed-only waves awaiting one fused device call
        self._pending: list[tuple[int, int]] = []  # (cap_index, seed_row)
        self._pending_tag_inits: list[tuple[int, int, int]] = []  # (t, row, w)
        self._pending_anchors: list[tuple[int, int]] = []  # (w, row)
        self.seed_anchors = getattr(solver_cfg, "seed_anchors", "multi")
        # register-then-refine: optimize each flush's NEW captures/tags
        # against the frozen map before the joint LM (see _flush)
        self.warmup = getattr(solver_cfg, "warmup_new_captures", True)
        # dist-path warmup accumulator: with optimize_every > 1 the
        # intervening optimize=False waves seed captures that must ALL be
        # warmed before the next joint LM (the single-device _flush warms
        # its whole pending batch; the dist path mirrors that here)
        self._dist_warm_caps: set[int] = set()
        self._dist_warm_tags: set[int] = set()
        # per-wave LM budget (traced); config.max_iterations is the static
        # bound and covers final_polish_iterations too (_lm_config)
        self.wave_budget = solver_cfg.max_iterations

    def _wave_call(self, camera, cap_poses, tag_poses, block_mask,
                   cam_active, cap_active, tag_active, seed_caps,
                   seed_blocks, wave_tags, wave_rows, wave_mask,
                   anchor_rows, anchor_mask, lm_enabled, iter_budget):
        """One fused wave dispatch (seed prologue + LM)."""
        return solve_wave_multi(
            camera, cap_poses, tag_poses, self.cap_idx, self.tag_idx,
            self.corners, block_mask, cam_active, cap_active, tag_active,
            seed_caps, seed_blocks, wave_tags, wave_rows, wave_mask,
            anchor_rows, anchor_mask, lm_enabled,
            aruco_size=self.aruco_size, config=self.config,
            assemble_fn=self.assemble_fn, seed_mode=self.seed_mode,
            obs_per_tag=self.obs_per_tag, obs_per_cap=self.obs_per_cap,
            row_slots=self.row_slots, tag_rows=self.tag_rows,
            cap_rows=self.cap_rows,
            iter_budget=jnp.asarray(iter_budget, jnp.int32))

    def polish(self, budget: int):
        """One extra LM pass (no new seeds) with a bigger iteration budget
        — same compiled program on both paths (traced iter_budget)."""
        if budget <= 0:
            return self.last_info
        if self._dist_wave is not None:
            return self._dispatch_dist_wave(
                cap_index=0, seed_row=-1, init_pairs=(), anchor_rows=(),
                optimize=True, iter_budget=budget, warmup=False)
        self._pending.append((0, -1))  # seed-nothing wave
        return self._flush(lm_enabled=True, iter_budget=budget)

    def run_wave(self, cap_index: int, seed_block: int | None,
                 optimize: bool = True):
        """Add one capture to the active problem and (optionally)
        re-optimize; optimize=False runs only the seed prologue."""
        store = self.store
        cap = store.captures[cap_index]
        self.active_caps.add(cap_index)

        init_pairs = []  # (old tag idx, device block row)
        anchor_rows = []  # blocks whose tags were ALREADY initialized
        for bh in cap.blocks:
            block = store.blocks[bh]
            self.active_blocks[bh] = True
            t = block.tag_idx
            self.active_tags[t] = True
            if not self.tag_initialized[t]:
                self.tag_initialized[t] = True
                init_pairs.append((t, self.row_of_block[bh]))
            else:
                anchor_rows.append(int(self.row_of_block[bh]))

        seed_row = -1 if seed_block is None else int(
            self.row_of_block[seed_block]
        )

        if self._dist_wave is None:
            # accumulate; dispatch ONE fused multi-wave program when this
            # wave optimizes (or at finish)
            w = len(self._pending)
            self._pending.append((cap_index, seed_row))
            for t, row in init_pairs:
                self._pending_tag_inits.append((t, int(row), w))
            if seed_row >= 0:
                if self.seed_anchors == "multi":
                    for row in anchor_rows:
                        self._pending_anchors.append((w, row))
                else:  # reference parity: the single init_block only
                    self._pending_anchors.append((w, seed_row))
            if optimize:
                return self._flush(lm_enabled=True)
            return None

        # distributed path: one device call per wave
        return self._dispatch_dist_wave(cap_index, seed_row, init_pairs,
                                        anchor_rows, optimize,
                                        self.wave_budget)

    def _dispatch_dist_wave(self, cap_index, seed_row, init_pairs,
                            anchor_rows, optimize, iter_budget,
                            warmup=None):
        tag_inv = self._prob.prep["tag_inv"]
        tag_init_blocks = np.full(self.t_new, -1, dtype=np.int32)
        for t, row in init_pairs:
            tag_init_blocks[tag_inv[t]] = row

        # capture-seed anchors, replicated (Sa,) slot arrays
        if self.seed_anchors != "multi" and seed_row >= 0:
            anchor_rows = [seed_row]
        sa = self._prob.obs_per_cap
        anc_rows = np.zeros(sa, dtype=np.int32)
        anc_mask = np.zeros(sa, dtype=bool)
        if seed_row >= 0:
            k = min(len(anchor_rows), sa)
            anc_rows[:k] = anchor_rows[:k]
            anc_mask[:k] = True

        cap_active = np.zeros(self.c_pad, dtype=bool)
        cap_active[list(self.active_caps)] = True
        prob = self._prob
        if warmup is None:  # a real capture wave (polish passes False)
            self._dist_warm_caps.add(cap_index)
            self._dist_warm_tags.update(t for t, _ in init_pairs)
            warmup = self.warmup and optimize
        # no warmup against an EMPTY established map (everything active is
        # new — there is no frozen basin to protect, and the extra LM pass
        # would only double first-flush device time)
        if not (self.active_caps - self._dist_warm_caps):
            warmup = False
        if warmup:
            # register-then-refine (see _flush): seeds + LM over ALL
            # captures/tags seeded since the last joint LM (this wave's
            # seeds apply here; earlier optimize=False waves applied their
            # own at dispatch) against the frozen map, then the joint pass
            # below runs with the seeds disabled
            warm_caps = np.zeros(self.c_pad, dtype=bool)
            warm_caps[list(self._dist_warm_caps)] = True
            warm_tags_old = np.zeros(self.t_pad, dtype=bool)
            for t in self._dist_warm_tags:
                warm_tags_old[t] = True
            (cam_a, cap_a, seed_c, seed_b, anc_r, anc_m, lm_en, budget) = (
                prob.put_rep(
                    np.asarray(False), warm_caps,
                    np.asarray(cap_index, np.int32),
                    np.asarray(seed_row, np.int32),
                    anc_rows, anc_mask,
                    np.asarray(True),
                    np.asarray(iter_budget, np.int32),
                ))
            (self.camera, self.cap_poses, self.tag_poses, _) = (
                self._dist_wave(
                    self.camera, self.cap_poses, self.tag_poses,
                    self.cap_idx, self.tag_idx, self.corners,
                    prob.block_mask(self.active_blocks),
                    cam_a, cap_a, prob.put_tag_mask(warm_tags_old),
                    seed_c, seed_b, prob.put_blocks(tag_init_blocks),
                    anc_r, anc_m,
                    lm_en, budget,
                )
            )
            seed_row = -1
            tag_init_blocks = np.full(self.t_new, -1, dtype=np.int32)
            anc_mask[:] = False
        (cam_a, cap_a, seed_c, seed_b, anc_r, anc_m, lm_en, budget) = (
            prob.put_rep(
                np.asarray(True), cap_active,
                np.asarray(cap_index, np.int32),
                np.asarray(seed_row, np.int32),
                anc_rows, anc_mask,
                np.asarray(optimize),
                np.asarray(iter_budget, np.int32),
            ))
        (self.camera, self.cap_poses, self.tag_poses, info) = (
            self._dist_wave(
                self.camera, self.cap_poses, self.tag_poses,
                self.cap_idx, self.tag_idx, self.corners,
                prob.block_mask(self.active_blocks),
                cam_a, cap_a, prob.put_tag_mask(self.active_tags.copy()),
                seed_c, seed_b, prob.put_blocks(tag_init_blocks),
                anc_r, anc_m,
                lm_en, budget,
            )
        )
        if optimize:
            self._dist_warm_caps.clear()
            self._dist_warm_tags.clear()
        self.last_info = info
        return info

    def _flush(self, lm_enabled: bool, iter_budget: int | None = None):
        """Dispatch the accumulated waves as one fused device call.

        ``iter_budget`` overrides the per-wave LM budget (traced — same
        compiled program; used by the final polish).

        NOTE: active_blocks / active_tags are mutated in place across waves
        while dispatch is async; jnp.asarray on CPU may alias the host
        buffer zero-copy, so hand the device an immutable copy.
        """
        if not self._pending:
            return self.last_info
        budget_i = int(self.wave_budget if iter_budget is None
                       else iter_budget)
        budget = jnp.asarray(budget_i, jnp.int32)
        t_flush = time.time()
        n = len(self._pending)
        from arslam.graph.arrays import bucket_size

        w_pad = max(bucket_size(n, floor=1), self.w_fixed)
        seed_caps = np.zeros(w_pad, dtype=np.int32)
        seed_blocks = np.full(w_pad, -1, dtype=np.int32)
        for w, (cap_index, seed_row) in enumerate(self._pending):
            seed_caps[w] = cap_index
            seed_blocks[w] = seed_row
        # per-wave tag-init slot tables (W, S): S fixed at the padded
        # max-observations-per-capture (new tags per wave <= blocks of the
        # wave's capture), so the slot axis never re-jits
        s_pad = self.obs_per_cap
        wave_tags = np.zeros((w_pad, s_pad), dtype=np.int32)
        wave_rows = np.zeros((w_pad, s_pad), dtype=np.int32)
        wave_mask = np.zeros((w_pad, s_pad), dtype=bool)
        slot = np.zeros(n, dtype=np.int64)
        for t, row, w in self._pending_tag_inits:
            s = slot[w]
            wave_tags[w, s] = t
            wave_rows[w, s] = row
            wave_mask[w, s] = True
            slot[w] += 1
        # capture-seed anchor tables (same fixed slot width)
        anchor_rows = np.zeros((w_pad, s_pad), dtype=np.int32)
        anchor_mask = np.zeros((w_pad, s_pad), dtype=bool)
        slot[:] = 0
        for w, row in self._pending_anchors:
            s = slot[w]
            anchor_rows[w, s] = row
            anchor_mask[w, s] = True
            slot[w] += 1
        # register-then-refine warmup masks: the flush's new captures/tags
        warm_caps = np.zeros(self.c_pad, dtype=bool)
        for cap_index, _ in self._pending:
            warm_caps[cap_index] = True
        warm_tags = np.zeros(self.t_pad, dtype=bool)
        for t, _, _ in self._pending_tag_inits:
            warm_tags[t] = True
        self._pending.clear()
        self._pending_tag_inits.clear()
        self._pending_anchors.clear()

        cap_active = np.zeros(self.c_pad, dtype=bool)
        cap_active[list(self.active_caps)] = True

        # Register-then-refine: one catastrophically chain-seeded batch of
        # captures can DRAG a converged map into a bad basin (measured:
        # a 10k-tag construction at stride 256 sat at rmse 0.37 px through
        # 1388 captures, then one flush exploded cost 350x and the map
        # never recovered).  First solve ONLY the new captures + their new
        # tags against the frozen established map (localize-style masks —
        # same compiled program, masks are runtime inputs), then run the
        # joint LM.  Polish flushes (iter_budget set) add no captures and
        # skip this.
        # skip when nothing established exists to register against (a
        # brand-new map's first flush: warmup would run a full LM with the
        # camera frozen and EVERY parameter new — pure extra device time)
        if (lm_enabled and self.warmup and iter_budget is None
                and warm_caps.any() and (cap_active & ~warm_caps).any()
                and not self.progress):
            (self.camera, self.cap_poses, self.tag_poses, _) = (
                self._wave_call(
                    self.camera, self.cap_poses, self.tag_poses,
                    jnp.asarray(self.active_blocks.copy()),
                    jnp.asarray(False), jnp.asarray(warm_caps),
                    jnp.asarray(warm_tags),
                    jnp.asarray(seed_caps), jnp.asarray(seed_blocks),
                    jnp.asarray(wave_tags), jnp.asarray(wave_rows),
                    jnp.asarray(wave_mask), jnp.asarray(anchor_rows),
                    jnp.asarray(anchor_mask),
                    jnp.asarray(True),
                    budget,
                ))
            # seeds were applied by the warmup dispatch; the joint pass
            # below must not re-apply them
            seed_caps = np.zeros(w_pad, dtype=np.int32)
            seed_blocks = np.full(w_pad, -1, dtype=np.int32)
            wave_mask = np.zeros_like(wave_mask)
            anchor_mask = np.zeros_like(anchor_mask)

        if lm_enabled and self.progress and self._dist_wave is None:
            # ≙ minimizer_progress_to_stdout (ar_slam_util.cpp:1012):
            # apply the seeds fused, then HOST-STEP the LM one iteration
            # per device call, printing a ceres-style line each time
            (self.camera, self.cap_poses, self.tag_poses, _) = (
                self._wave_call(
                    self.camera, self.cap_poses, self.tag_poses,
                    jnp.asarray(self.active_blocks.copy()),
                    jnp.asarray(True), jnp.asarray(cap_active),
                    jnp.asarray(self.active_tags.copy()),
                    jnp.asarray(seed_caps), jnp.asarray(seed_blocks),
                    jnp.asarray(wave_tags), jnp.asarray(wave_rows),
                    jnp.asarray(wave_mask), jnp.asarray(anchor_rows),
                    jnp.asarray(anchor_mask),
                    jnp.asarray(False),
                    budget,
                ))
            self.last_info = self._lm_host_stepped(cap_active, budget_i)
            return self.last_info

        (self.camera, self.cap_poses, self.tag_poses, info) = (
            self._wave_call(
                self.camera, self.cap_poses, self.tag_poses,
                jnp.asarray(self.active_blocks.copy()),
                jnp.asarray(True),
                jnp.asarray(cap_active),
                jnp.asarray(self.active_tags.copy()),
                jnp.asarray(seed_caps),
                jnp.asarray(seed_blocks),
                jnp.asarray(wave_tags),
                jnp.asarray(wave_rows),
                jnp.asarray(wave_mask),
                jnp.asarray(anchor_rows),
                jnp.asarray(anchor_mask),
                jnp.asarray(lm_enabled),
                budget,
            )
        )
        self.last_info = info
        if logger.isEnabledFor(logging.DEBUG):
            # forces a device sync — debug only
            logger.debug(
                "flush: %d waves (pad %d) lm=%s iters=%s cost=%.6g %.2fs",
                n, w_pad, bool(lm_enabled), int(info["iterations"]),
                float(info["cost"]), time.time() - t_flush)
        return info

    def _lm_host_stepped(self, cap_active, budget: int):
        """One LM iteration per device call, printing ceres-style progress
        lines (≙ minimizer_progress_to_stdout, ar_slam_util.cpp:1012).
        The damping schedule threads through lam0/nu0 so the sequence of
        (lambda, nu) matches the fused while_loop's exactly.  ``budget`` is
        the wave's iteration budget (the static config.max_iterations is
        inflated to cover final_polish_iterations and must not bound
        ordinary waves)."""
        import time as _time

        from arslam.solve.lm import TERMINATION_REASONS, lm_solve

        cfg = self.config
        dtype = self.cap_poses.dtype
        lam, nu = cfg.initial_lambda, 2.0
        prev_cost = None
        t_start = _time.time()
        print("iter      cost      cost_change  |gradient|  "
              "tr_radius   iter_time  total_time")
        info = None
        for it in range(min(budget, cfg.max_iterations)):
            t0 = _time.time()
            (self.camera, self.cap_poses, self.tag_poses, info) = lm_solve(
                self.camera, self.cap_poses, self.tag_poses,
                self.cap_idx, self.tag_idx, self.corners,
                jnp.asarray(self.active_blocks.copy()),
                jnp.asarray(True), jnp.asarray(cap_active),
                jnp.asarray(self.active_tags.copy()),
                aruco_size=self.aruco_size, config=cfg,
                assemble_fn=self.assemble_fn,
                iter_budget=jnp.asarray(1, jnp.int32),
                lam0=jnp.asarray(lam, dtype), nu0=jnp.asarray(nu, dtype),
                obs_per_tag=self.obs_per_tag, obs_per_cap=self.obs_per_cap,
                row_slots=self.row_slots, tag_rows=self.tag_rows,
                cap_rows=self.cap_rows,
            )
            cost = float(info["cost"])
            lam, nu = float(info["lambda"]), float(info["nu"])
            dcost = 0.0 if prev_cost is None else prev_cost - cost
            now = _time.time()
            print(f"{it:4d}  {cost:11.6e}  {dcost:11.2e}  "
                  f"{float(info['grad_max']):11.2e}  "
                  f"{1.0 / max(lam, 1e-30):10.2e}  {now - t0:9.2e}  "
                  f"{now - t_start:9.2e}")
            prev_cost = cost
            if bool(info["converged"]):
                print("terminating: "
                      + TERMINATION_REASONS.get(int(info["termination"]),
                                                "?"))
                break
        if info is not None:
            info = {**info, "iterations": jnp.asarray(it + 1, jnp.int32)}
        return info

    def true_sq_cost(self) -> float:
        """0.5 * sum of RAW squared residuals on the current device state —
        the robust (huber) solve cost is not a sum of squares, so reported
        pixel RMSE must come from this instead."""
        from arslam.solve.residuals import total_cost

        if self._dist_wave is not None:
            # pull state host-side; one eval per solve, size is small
            # (fetch all-gathers sharded tag state across processes)
            from arslam.parallel.multihost import fetch

            tag_poses = self._prob.tags_to_old(self.tag_poses, self.t_pad)
            arrs = self.arrs
            return float(total_cost(
                jnp.asarray(fetch(self.camera)),
                jnp.asarray(fetch(self.cap_poses)),
                jnp.asarray(tag_poses), jnp.asarray(arrs.cap_idx),
                jnp.asarray(arrs.tag_idx), jnp.asarray(arrs.corners),
                jnp.asarray(self.active_blocks.copy()), self.aruco_size,
                self.config.enable_distortion))
        return float(total_cost(
            self.camera, self.cap_poses, self.tag_poses, self.cap_idx,
            self.tag_idx, self.corners,
            jnp.asarray(self.active_blocks.copy()), self.aruco_size,
            self.config.enable_distortion))

    def finish(self):
        if self._dist_wave is None:
            # leftover seed-only waves (optimize_every tail without a final
            # optimizing wave)
            self._flush(lm_enabled=False)
        if self._dist_wave is not None:
            tag_poses = self._prob.tags_to_old(self.tag_poses, self.t_pad)
        else:
            tag_poses = np.asarray(self.tag_poses)
        from arslam.parallel.multihost import fetch

        write_back(self.store, fetch(self.camera),
                   fetch(self.cap_poses), tag_poses)
        if self.last_info is not None:
            logger.info(
                "solve done: cost=%s iters(last wave)=%s",
                float(self.last_info["cost"]),
                int(self.last_info["iterations"]),
            )


def _resolve_mesh(mesh, config):
    """mesh arg wins; else config.dist.num_devices > 1 builds a block mesh."""
    if mesh is not None:
        return mesh
    n = getattr(getattr(config, "dist", None), "num_devices", 0)
    if n and n > 1:
        from arslam.parallel.mesh import block_mesh

        return block_mesh(n)
    return None


def solve(store: MapStore, config=None, dtype=None, assemble_fn=None,
          mesh=None) -> dict:
    """Batch BFS solve (≙ ArSlamSolver::solve).

    With ``mesh`` (or config.dist.num_devices > 1) the per-wave LM runs
    distributed with the observation axis sharded over the mesh.
    Returns a summary dict (final cost, waves, rmse).
    """
    from arslam.config import ArSlamConfig

    config = config or ArSlamConfig()
    dtype = dtype or _default_dtype(config)
    mesh = _resolve_mesh(mesh, config)
    if not store.captures:
        return {"waves": 0}
    _maybe_calibrate_focal(store, config)

    # reset init_block marks so re-solve behaves like a fresh BFS
    for cap in store.captures:
        cap.init_block = None

    seed = store.capture_with_most_blocks()
    order = store.connected_component(seed)
    if len(order) < len(store.captures):
        logger.warning(
            "%d captures are disconnected from the seed component and stay "
            "unsolved", len(store.captures) - len(order),
        )

    runner = _WaveRunner(store, config.solver, config.aruco_size, dtype,
                         assemble_fn, mesh=mesh, camera_cfg=config.camera)
    every = max(getattr(config.solver, "optimize_every", 1), 1)
    # geometric marks: optimize after waves 1, ceil(g), ceil(ceil(g)*g), …
    # — frequent early full solves keep chained seed drift bounded while
    # the fixed stride amortizes the established-map phase
    growth = float(getattr(config.solver, "optimize_growth", 0.0) or 0.0)
    geo_marks: set[int] = set()
    if growth > 1.0:
        nxt = 1
        while nxt <= len(order):
            geo_marks.add(nxt - 1)
            nxt = max(nxt + 1, int(np.ceil(nxt * growth)))
    for i, cap_index in enumerate(order):
        seed_block = None
        if cap_index != seed:
            seed_block = store.captures[cap_index].init_block
        optimize = ((i % every == every - 1) or (i == len(order) - 1)
                    or i in geo_marks)
        runner.run_wave(cap_index, seed_block, optimize=optimize)
        store.unsolved_captures.discard(cap_index)
    runner.polish(getattr(config.solver, "final_polish_iterations", 0))
    runner.finish()

    info = runner.last_info
    sq = (float(info["cost"]) if config.solver.loss == "trivial"
          else runner.true_sq_cost())
    return {
        "waves": len(order),
        "cost": float(info["cost"]),
        "rmse": rmse_from_cost(sq, int(np.sum(runner.active_blocks))),
    }


def solve_incremental(store: MapStore, config=None, dtype=None,
                      assemble_fn=None, mesh=None, _runner_cache={}) -> dict:
    """Incremental solve (≙ ArSlamSolver::solveIncremental): repeatedly
    attach unsolved captures that share an initialized tag with the solved
    set; each attachment re-optimizes the whole active problem."""
    from arslam.config import ArSlamConfig

    config = config or ArSlamConfig()
    dtype = dtype or _default_dtype(config)
    mesh = _resolve_mesh(mesh, config)
    if not store.captures:
        return {"waves": 0}
    _maybe_calibrate_focal(store, config)

    runner = _WaveRunner(store, config.solver, config.aruco_size, dtype,
                         assemble_fn, mesh=mesh, camera_cfg=config.camera)
    # replay already-solved captures into the runner's active set without
    # re-optimizing (their poses came from the export)
    solved = [c.index for c in store.captures
              if c.index not in store.unsolved_captures]
    for idx in solved:
        runner.active_caps.add(idx)
        for bh in store.captures[idx].blocks:
            runner.active_blocks[bh] = True
            t = store.blocks[bh].tag_idx
            runner.active_tags[t] = True
            runner.tag_initialized[t] = True

    waves = 0
    # if nothing is solved yet, solve an arbitrary first capture
    if len(store.unsolved_captures) == len(store.captures):
        first = min(store.unsolved_captures)
        logger.info("Solving initial capture %d", first)
        store.unsolved_captures.discard(first)
        runner.run_wave(first, None)
        waves += 1

    repeat = True
    while repeat:
        repeat = False
        for cap_index in sorted(store.unsolved_captures):
            cap = store.captures[cap_index]
            connect = None
            for bh in cap.blocks:
                t = store.blocks[bh].tag_idx
                if runner.tag_initialized[t]:
                    connect = bh
                    break
            if connect is not None:
                logger.info(
                    "Capture %s can be solved through %s",
                    cap.uid, store.arucos[store.blocks[connect].tag_idx].id,
                )
                store.unsolved_captures.discard(cap_index)
                runner.run_wave(cap_index, connect)
                waves += 1
                repeat = True
                break
    runner.finish()
    out = {"waves": waves, "unsolved": len(store.unsolved_captures)}
    if runner.last_info is not None:
        out["cost"] = float(runner.last_info["cost"])
        sq = (out["cost"] if config.solver.loss == "trivial"
              else runner.true_sq_cost())
        out["rmse"] = rmse_from_cost(sq, int(np.sum(runner.active_blocks)))
    return out


def rmse_from_cost(cost: float, n_blocks: int) -> float:
    """Reprojection RMSE in pixels from 0.5*sum-sq cost over 8-residual
    blocks."""
    if n_blocks == 0:
        return 0.0
    return float(np.sqrt(2.0 * cost / (8 * n_blocks)))


def _default_dtype(config):
    import numpy as np

    return {"float32": np.float32, "float64": np.float64}[config.solver.dtype]
