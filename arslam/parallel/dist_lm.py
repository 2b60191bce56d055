"""Distributed LM: TAG-SHARDED Schur elimination over the device mesh.

Design (SURVEY.md §2.3, §5.7-5.8; docs/distributed.md): the landmark
(tag) axis is partitioned over a 1-D mesh and the block (observation) table
is repacked so each device's slice holds exactly its tags' observations
(``parallel.partition.prepare_tag_shards``).  Consequences per LM
iteration:

- residuals/Jacobians and the TAG-side normal-equation blocks (per-tag 6x6
  V, the capture-sparse (t, S, 6, 6) coupling blocks, tag gradients)
  assemble **locally** — they never cross the interconnect;
- the CAPTURE-side blocks psum once (~C*63 floats — tiny);
- each device Schur-eliminates ITS tags (damped 6x6 inverses, Y = W V^-1,
  the per-tag (Nr, Nr) contributions) — the heavy elimination compute
  splits across the mesh instead of replicating — and ONE psum of the
  additive reduced system (Nr^2 floats) replicates S;
- linear_solver='dense': the reduced Cholesky (3 + 6C unknowns) runs
  replicated (the only serial part — Amdahl headroom is set by its share
  of an iteration).  linear_solver='cg': no reduced system is ever formed —
  the implicit-Schur CG runs against each shard's sparse coupling blocks
  with ONE packed (Nr,) psum per matvec (≙ ITERATIVE_SCHUR on the mesh);
- back-substitution of tag updates is again local; tag pose state stays
  sharded P("blocks") for the whole solve.

Communication per iteration: exactly TWO all-reduces — the solve packs its
reduction into one psum (the dense path's reduced system, or one (Nr,)
downdate per CG matvec), and the FUSED step-quality + speculative
relinearization packs the 3 quality scalars together with the relinearized
CapEqs into one (``make_quality_lin``; round 1 spent three — quality and
the accept-path relinearize each psum-ed separately).  ``_psum_packed``
keeps each stage at one collective: on latency-bound links (cross-host
networks, gloo in the multi-process CPU simulation) collective COUNT
dominates payload, and
the payloads here are tiny and map-size-independent.  Compare the naive
observation-sharded design, which psums the full (6C, 6T) coupling (≈2x
the bytes) and replicates the entire elimination.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from arslam.parallel.mesh import BLOCK_AXIS
from arslam.parallel.multihost import fetch, put_global
from arslam.parallel.partition import prepare_tag_shards
from arslam.solve.lm import LMConfig, lm_core
from arslam.solve.residuals import linearize, residuals_and_rho
from arslam.solve.schur import (
    CapEqs,
    GroupedEqs,
    TagRows,
    assemble_grouped,
    backsub_tags_sparse,
    cap_scale_vectors,
    eliminate_tags_grouped,
    group_blocks_by_tag,
    group_blocks_by_tag_rows,
    quad_form_cap_side,
    quad_form_tag_side,
    reduced_solve,
    schur_solve_grouped_cg,
)


def _psum_packed(arrs):
    """ONE all-reduce for several same-dtype arrays (ravel+concat, psum,
    split).  The per-iteration reductions are small (the reduced camera
    system + a few scalars), so on latency-bound links (a cross-host
    network, or gloo in
    the multi-process CPU simulation) collective COUNT dominates payload;
    packing turns up to 6 psums per stage into one."""
    shapes = [jnp.shape(a) for a in arrs]
    sizes = [int(np.prod(s)) for s in shapes]
    dtypes = {jnp.asarray(a).dtype for a in arrs}
    assert len(dtypes) == 1, (
        f"_psum_packed requires one dtype, got {sorted(map(str, dtypes))}: "
        "concatenate would silently promote and change downstream dtypes")
    flat = jnp.concatenate([jnp.ravel(a) for a in arrs])
    flat = jax.lax.psum(flat, BLOCK_AXIS)
    out, off = [], 0
    for s, sz in zip(shapes, sizes):
        out.append(flat[off:off + sz].reshape(s))
        off += sz
    return out


def make_tag_sharded_hooks(mesh, t_per, n_caps, aruco_size,
                           jacobi_scaling=True, distortion=False,
                           obs_per_tag: int = 8, obs_per_cap: int = 8,
                           loss="trivial", loss_scale=1.0,
                           linear_solver: str = "dense",
                           cg_tol: float = 1e-2, cg_iters: int = 100,
                           row_slots: int | None = None,
                           shard_rows: int | None = None,
                           shard_cap_rows: int | None = None):
    """Build (group_fn, lin_fn, quality_fn, solve_fn factories) for lm_core
    with tags sharded over the mesh.

    All tag-indexed arrays (tag_poses, tag_active, the block table) must be
    in the RENUMBERED tag order from prepare_tag_shards, with global tag
    count t_per * n_devices; block ``tag_idx`` carries the new GLOBAL ids
    (converted to shard-local inside the kernels via axis_index).

    ``obs_per_tag`` is the static per-tag slot count for the scatter-free
    grouped assembly (global max observations per tag; shared by all
    shards); ``obs_per_cap`` bounds observations per capture (global max —
    a shard's per-capture count can only be smaller) for the shard-local
    capture-grouped reductions.  Each shard regroups ITS block slice once
    per solve via ``make_group`` — sorts and gathers stay shard-local.

    ``linear_solver='cg'`` replaces the replicated dense reduced Cholesky
    with the tag-sharded implicit-Schur CG (≙ ITERATIVE_SCHUR): the
    elimination state stays capture-sparse on each shard and every CG
    matvec psums one packed (Nr,) downdate — per-step traffic independent
    of tag count.
    """
    blockspec = P(BLOCK_AXIS)
    tagspec = P(BLOCK_AXIS)
    rep = P()
    sc_max = obs_per_cap
    # ROW-SPLIT layout (CG only; see solve/lm.make_grouped_hooks): each
    # shard packs ITS tags' slots into shard_rows rows of row_slots each —
    # the per-shard grouped table shrinks from (t_per, S_max) to
    # ~1.2x its observation count.  shard_rows is the static PER-SHARD
    # row budget (same on every shard; callers size it for the worst one).
    use_rows = row_slots is not None and linear_solver == "cg"
    use_cap_rows = use_rows and shard_cap_rows is not None
    s_max = row_slots if use_rows else obs_per_tag
    max_rows = -(-obs_per_tag // row_slots) if use_rows else 1
    max_cap_rows = -(-obs_per_cap // row_slots) if use_cap_rows else 1
    n_extra = (4 if use_rows else 0) + (4 if use_cap_rows else 0)
    group_out = (blockspec,) * (6 + n_extra)

    def _local_tags(ti):
        return ti - jax.lax.axis_index(BLOCK_AXIS) * t_per

    def _split_rows(ra):
        """(tag TagRows | None, cap TagRows | None) from the flat extras."""
        tag_r = TagRows(*ra[:4]) if use_rows else None
        cap_r = TagRows(*ra[4:8]) if use_cap_rows else None
        return tag_r, cap_r

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(blockspec, blockspec, blockspec, blockspec),
        out_specs=group_out,
    )
    def make_group(ci, ti, crn, bm):
        """Regroup this shard's blocks by local tag into (t_per * S) slots
        (or, row-split, (shard_rows * row_slots) slots), plus the
        shard-local capture-grouped permutation over those slots.
        Returns a grouped block table with GLOBAL new tag ids (+ the
        TagRows arrays in row mode)."""
        til = _local_tags(ti)
        if use_rows:
            gather, mask_g, rows = group_blocks_by_tag_rows(
                til, bm, t_per, row_slots, shard_rows, max_rows)
            til_g = jnp.repeat(rows.row_tag, row_slots,
                               total_repeat_length=shard_rows * row_slots)
            extra = tuple(rows)
        else:
            gather, mask_g = group_blocks_by_tag(til, bm, t_per, s_max)
            til_g = jnp.repeat(jnp.arange(t_per, dtype=jnp.int32), s_max,
                               total_repeat_length=t_per * s_max)
            extra = ()
        ci_g = ci[gather]
        if use_cap_rows:
            cap_gather, cap_gmask, cap_rows = group_blocks_by_tag_rows(
                ci_g, mask_g, n_caps, row_slots, shard_cap_rows,
                max_cap_rows)
            extra = extra + tuple(cap_rows)
        else:
            cap_gather, cap_gmask = group_blocks_by_tag(ci_g, mask_g,
                                                        n_caps, sc_max)
        ti_g = til_g + jax.lax.axis_index(BLOCK_AXIS).astype(jnp.int32) * t_per
        return (ci_g, ti_g, crn[gather], mask_g, cap_gather, cap_gmask
                ) + extra

    cap_rep = (rep, rep, rep, rep, rep)
    tag_shard = (tagspec, tagspec, tagspec, tagspec)

    def make_lin(cap_idx, tag_idx, corners, block_mask, cap_gather,
                 cap_gmask, *row_arrs):
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(rep, rep, tagspec, blockspec, blockspec, blockspec,
                      blockspec, blockspec, blockspec)
            + (blockspec,) * len(row_arrs),
            out_specs=(
                (rep, tag_shard),  # eqs
                rep,  # cost
            ),
        )
        def _lin(camera, cap_poses, tag_poses, ci, ti, crn, bm, cg, cgm,
                 *ra):
            til = _local_tags(ti)
            r, jc, jp, jt, rho = linearize(
                camera, cap_poses, tag_poses, ci, til, crn, bm, aruco_size,
                distortion, loss, loss_scale,
            )
            tag_r, cap_r = _split_rows(ra)
            g = assemble_grouped(r, jc, jp, jt, cg, cgm, n_caps, t_per,
                                 s_max, rows=tag_r, cap_rows=cap_r)
            hcc, hcp, hpp, g_c, g_p, cost = _psum_packed(
                [g.hcc, g.hcp, g.hpp, g.g_c, g.g_p, 0.5 * jnp.sum(rho)])
            cap_eqs = CapEqs(hcc, hcp, hpp, g_c, g_p)
            tag_side = (g.hct, g.wt_s, g.htt, g.g_t)
            return (cap_eqs, tag_side), cost

        def lin_fn(camera, cap_poses, tag_poses):
            return _lin(camera, cap_poses, tag_poses, cap_idx, tag_idx,
                        corners, block_mask, cap_gather, cap_gmask,
                        *row_arrs)

        return lin_fn

    def make_quality(cap_idx, tag_idx, corners, block_mask, cap_gather,
                     cap_gmask, *row_arrs):
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                (cap_rep, tag_shard),
                rep, rep, tagspec, rep, rep, tagspec,
                blockspec, blockspec, blockspec, blockspec,
            ) + (blockspec,) * len(row_arrs),
            out_specs=(rep, rep, rep),
        )
        def _quality(eqs, new_camera, new_caps, new_tags, d_cam, d_cap,
                     d_tag, ci, ti, crn, bm, *ra):
            cap_eqs, (hct, wt_s, htt, g_t) = eqs
            til = _local_tags(ti)
            _, rho_new = residuals_and_rho(
                new_camera, new_caps, new_tags, ci, til, crn, bm, aruco_size,
                distortion, loss, loss_scale,
            )
            tag_r, _ = _split_rows(ra)
            # tag-side quad partials are additive over shards; the cap side
            # is replicated and added after the psum (summing it through
            # the psum would scale it by n_devices)
            gd_t, q_t = quad_form_tag_side(hct, wt_s, htt, g_t, ci, d_cam,
                                           d_cap, d_tag, rows=tag_r)
            new_cost, gd_t, q_t = _psum_packed(
                [0.5 * jnp.sum(rho_new), gd_t, q_t])
            gd_c, q_c = quad_form_cap_side(*cap_eqs, d_cam, d_cap)
            return new_cost, gd_c + gd_t, q_c + q_t

        def quality_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap,
                       d_tag):
            cap_eqs, tag_side = eqs
            return _quality((tuple(cap_eqs), tag_side), new_camera,
                            new_caps, new_tags, d_cam, d_cap, d_tag,
                            cap_idx, tag_idx, corners, block_mask,
                            *row_arrs)

        return quality_fn

    def make_quality_lin(cap_idx, tag_idx, corners, block_mask, cap_gather,
                         cap_gmask, *row_arrs):
        """Fused step-quality + SPECULATIVE relinearization at the proposed
        parameters: the quality scalars ride the same packed psum as the
        relinearized capture-side blocks, so an LM iteration costs TWO
        all-reduces (solve + this) instead of three (solve + quality +
        accept-path linearize).  On latency-bound links collective count
        dominates; the extra Jacobian work on rejected steps is local.
        Step quality reads d^T g / d^T H d off the CURRENT assembled eqs
        (quad_form_*), so the per-block Jacobians are consumed inside this
        stage and never enter the loop carry."""
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                (cap_rep, tag_shard),
                rep, rep, tagspec, rep, rep, tagspec,
                blockspec, blockspec, blockspec, blockspec, blockspec,
                blockspec,
            ) + (blockspec,) * len(row_arrs),
            out_specs=(rep, rep, rep, (rep, tag_shard)),
        )
        def _qlin(eqs, new_camera, new_caps, new_tags, d_cam, d_cap,
                  d_tag, ci, ti, crn, bm, cg, cgm, *ra):
            cap_eqs, (hct, wt_s, htt, g_t) = eqs
            til = _local_tags(ti)
            r2, jc2, jp2, jt2, rho2 = linearize(
                new_camera, new_caps, new_tags, ci, til, crn, bm, aruco_size,
                distortion, loss, loss_scale,
            )
            tag_r, cap_r = _split_rows(ra)
            g = assemble_grouped(r2, jc2, jp2, jt2, cg, cgm, n_caps, t_per,
                                 s_max, rows=tag_r, cap_rows=cap_r)
            gd_t, q_t = quad_form_tag_side(hct, wt_s, htt, g_t, ci, d_cam,
                                           d_cap, d_tag, rows=tag_r)
            (hcc, hcp, hpp, g_c, g_p, new_cost, gd_t, q_t) = (
                _psum_packed([g.hcc, g.hcp, g.hpp, g.g_c, g.g_p,
                              0.5 * jnp.sum(rho2), gd_t, q_t]))
            gd_c, q_c = quad_form_cap_side(*cap_eqs, d_cam, d_cap)
            new_eqs = (CapEqs(hcc, hcp, hpp, g_c, g_p),
                       (g.hct, g.wt_s, g.htt, g.g_t))
            return new_cost, gd_c + gd_t, q_c + q_t, new_eqs

        def quality_lin_fn(eqs, new_camera, new_caps, new_tags, d_cam,
                           d_cap, d_tag):
            cap_eqs, tag_side = eqs
            new_cost, g_dot_d, jd_sq, new_eqs = _qlin(
                (tuple(cap_eqs), tag_side), new_camera, new_caps, new_tags,
                d_cam, d_cap, d_tag, cap_idx, tag_idx, corners, block_mask,
                cap_gather, cap_gmask, *row_arrs)
            return new_cost, g_dot_d, jd_sq, new_eqs

        return quality_lin_fn

    def make_solve(cam_active, cap_active, tag_active, grouped):
        ci_g, _, _, _, cap_gather, cap_gmask = grouped[:6]
        row_arrs = grouped[6:]

        if linear_solver == "cg":
            # The whole damped solve (implicit-Schur CG + back-substitution)
            # runs inside ONE shard_map: shards keep their capture-sparse
            # elimination state local and psum one packed (Nr,) vector per
            # CG matvec (plus one packed [preconditioner, rhs] at setup) —
            # the reference's ITERATIVE_SCHUR, lifted onto the mesh.
            # check_vma=False: the replicated outputs are replicated by
            # CONSTRUCTION (every shard psums the additive downdates, so all
            # shards run CG on identical vectors), but the static
            # varying-axes checker cannot see through the closed-over
            # activity masks and the CG while_loop.
            @partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=((rep, rep, rep, rep, rep),
                          (tagspec, tagspec, tagspec, tagspec),
                          blockspec, blockspec, blockspec,
                          tagspec, rep, rep)
                + (blockspec,) * len(row_arrs),
                out_specs=(rep, rep, tagspec, rep),
                check_vma=False,
            )
            def _cg_solve(cap_eqs, tag_side, ci, cg, cgm, tag_a, lam, x0,
                          *ra):
                hct, wt_s, htt, g_t = tag_side
                eqs = GroupedEqs(cap_eqs[0], cap_eqs[1], cap_eqs[2],
                                 hct, wt_s, htt, cap_eqs[3], cap_eqs[4],
                                 g_t)
                tag_r, cap_r = _split_rows(ra)
                d_cam, d_cap, d_tag, delta_r = schur_solve_grouped_cg(
                    eqs, ci, cg, cgm, lam, cam_active, cap_active, tag_a,
                    jacobi_scaling=jacobi_scaling, cg_tol=cg_tol,
                    cg_iters=cg_iters, x0=x0, reduce_fn=_psum_packed,
                    rows=tag_r, cap_rows=cap_r,
                )
                return d_cam, d_cap, d_tag, delta_r

            def solve_fn(eqs, lam, x0):
                cap_eqs, tag_side = eqs
                return _cg_solve(tuple(cap_eqs), tag_side, ci_g, cap_gather,
                                 cap_gmask, tag_active, lam, x0, *row_arrs)

            return solve_fn

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=((tagspec, tagspec, tagspec, tagspec), blockspec,
                      rep, rep, tagspec, rep),
            out_specs=(rep, rep,
                       (tagspec, tagspec, tagspec, tagspec, tagspec)),
        )
        def _elim(tag_side, ci, s_c, s_p, tag_a, lam):
            hct, wt_s, htt, g_t = tag_side
            wvw, wvg, ctx = eliminate_tags_grouped(
                hct, wt_s, ci, htt, g_t, s_c, s_p, tag_a, lam,
                jacobi_scaling,
            )
            wvw, wvg = _psum_packed([wvw, wvg])
            return wvw, wvg, ctx

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=((tagspec, tagspec, tagspec, tagspec, tagspec),
                      blockspec, tagspec, rep),
            out_specs=tagspec,
        )
        def _backsub(ctx, ci, tag_a, delta_r):
            v_inv, hct_s, wt_ss, g_t_s, s_t = ctx
            return backsub_tags_sparse(v_inv, hct_s, wt_ss, ci, g_t_s, s_t,
                                       tag_a, delta_r)

        def solve_fn(eqs, lam):
            cap_eqs, tag_side = eqs
            s_c, s_p = cap_scale_vectors(cap_eqs, cam_active, cap_active,
                                         jacobi_scaling)
            wvw, wvg, ctx = _elim(tag_side, ci_g, s_c, s_p, tag_active, lam)
            delta_r, d_cam, d_cap = reduced_solve(
                cap_eqs, s_c, s_p, cam_active, cap_active, lam, wvw, wvg,
            )
            d_tag = _backsub(ctx, ci_g, tag_active, delta_r)
            return d_cam, d_cap, d_tag

        return solve_fn

    return make_group, make_lin, make_quality, make_quality_lin, make_solve


class TagShardedProblem:
    """Host-side prep: tag renumbering + block repack + device placement.

    Produces device arrays in the sharded layout and converts results back
    to the original tag numbering.
    """

    def __init__(self, mesh, cap_idx, tag_idx, corners, block_mask, n_tags):
        self.mesh = mesh
        self.n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        cap_idx = np.asarray(cap_idx)
        tag_idx = np.asarray(tag_idx)
        corners = np.asarray(corners)
        block_mask = np.asarray(block_mask)
        self.prep = prepare_tag_shards(
            cap_idx, tag_idx, block_mask, n_tags, self.n_dev
        )
        p = self.prep
        # static slot count for the grouped (scatter-free) assembly:
        # global max observations per tag, bucketed (shared by all shards)
        from arslam.graph.arrays import obs_bucket

        counts = np.bincount(tag_idx[block_mask], minlength=n_tags)
        self.obs_per_tag = obs_bucket(int(counts.max()) if counts.size
                                      else 1)
        ccounts = np.bincount(cap_idx[block_mask])
        self.obs_per_cap = obs_bucket(int(ccounts.max()) if ccounts.size
                                      else 1)
        # per-shard ROW-SPLIT budget for the CG path: rows needed by the
        # heaviest shard (tags are renumbered into contiguous per-shard
        # ranges, so count per new-tag and sum per range), bucketed
        self.row_slots = 8
        new_counts = np.bincount(
            np.asarray(p["new_tag_idx"])[p["row_mask"]],
            minlength=p["t_new"])
        rows_per_tag = -(-new_counts // self.row_slots)
        per_shard = rows_per_tag.reshape(self.n_dev, p["t_per"]).sum(axis=1)
        self.shard_rows = obs_bucket(int(per_shard.max()) if per_shard.size
                                     else 1)
        # per-shard CAPTURE-row budget: each shard groups ITS slots by
        # capture; size for the heaviest shard
        b_shard = p["b_shard"]
        ci_new = np.asarray(cap_idx)[p["row_gather"]]
        worst = 1
        for s in range(self.n_dev):
            sl = slice(s * b_shard, (s + 1) * b_shard)
            m = p["row_mask"][sl]
            if m.any():
                cc = np.bincount(ci_new[sl][m])
                worst = max(worst, int((-(-cc // self.row_slots)).sum()))
        self.shard_cap_rows = obs_bucket(worst)
        self.t_per = p["t_per"]
        self.t_new = p["t_new"]
        rg = p["row_gather"]
        self._shard = NamedSharding(mesh, P(BLOCK_AXIS))
        self._hpt_shard = NamedSharding(mesh, P(None, BLOCK_AXIS))
        self._rep = NamedSharding(mesh, P())
        self.cap_idx = self.put_blocks(cap_idx[rg].astype(np.int32))
        self.tag_idx = self.put_blocks(p["new_tag_idx"])
        self.corners = self.put_blocks(corners[rg])
        self.base_mask = p["row_mask"]

    def put_blocks(self, arr):
        return put_global(arr, self._shard)

    def put_tags(self, arr):
        """Permute an old-tag-indexed array into shard order and place it.
        Padding slots (which gather old tag 0's row) are zeroed so they
        contribute nothing to norms/costs."""
        out = np.asarray(arr)[self.prep["tag_perm"]].copy()
        invalid = ~self.prep["tag_slot_valid"]
        if invalid.any():
            out[invalid] = 0
        return put_global(out, self._shard)

    def put_tag_mask(self, mask_old):
        """Permute an activity mask, forcing padding tag slots inactive
        (they alias old tag 0's row and must not become parameters)."""
        m = np.asarray(mask_old)[self.prep["tag_perm"]]
        return put_global(m & self.prep["tag_slot_valid"], self._shard)

    def put_rep(self, *arrs):
        return tuple(put_global(np.asarray(a), self._rep) for a in arrs)

    def block_mask(self, active_old):
        """Map an old-row activity mask into the repacked layout."""
        m = np.asarray(active_old)[self.prep["row_gather"]] & self.base_mask
        return self.put_blocks(m)

    def tags_to_old(self, arr_new, n_old):
        """Inverse-permute a tag-indexed result back to old numbering.
        Works across processes: sharded device results all-gather via
        multihost.fetch (host numpy inputs pass through)."""
        return fetch(arr_new)[self.prep["tag_inv"][:n_old]]

    def row_of_block(self, old_row):
        return int(self.prep["row_of_block"][old_row])


@lru_cache(maxsize=32)
def _dist_lm_runner(mesh, t_per, n_caps, aruco_size, config, obs_per_tag,
                    obs_per_cap, row_slots=None, shard_rows=None,
                    shard_cap_rows=None):
    """Memoized jitted distributed-LM program: repeated lm_solve_dist calls
    with the same mesh/shape/config hit the jit cache instead of
    re-tracing."""
    make_group, make_lin, make_quality, make_quality_lin, make_solve = (
        make_tag_sharded_hooks(
            mesh, t_per, n_caps, aruco_size, config.jacobi_scaling,
            config.enable_distortion, obs_per_tag, obs_per_cap,
            loss=config.loss, loss_scale=config.loss_scale,
            linear_solver=config.linear_solver, cg_tol=config.cg_tolerance,
            cg_iters=config.cg_max_iterations, row_slots=row_slots,
            shard_rows=shard_rows, shard_cap_rows=shard_cap_rows,
        )
    )

    @jax.jit
    def run(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
            block_mask, cam_active, cap_active, tag_active):
        # per-shard regroup ONCE (outside the LM while_loop)
        grouped = make_group(cap_idx, tag_idx, corners, block_mask)
        lin_fn = make_lin(*grouped)
        quality_fn = make_quality(*grouped)
        quality_lin_fn = make_quality_lin(*grouped)
        solve_fn = make_solve(cam_active, cap_active, tag_active, grouped)
        solver_state0 = None
        if config.linear_solver == "cg":
            solver_state0 = jnp.zeros(3 + 6 * n_caps, cap_poses.dtype)
        return lm_core(camera, cap_poses, tag_poses, cam_active, cap_active,
                       tag_active, lin_fn, quality_fn, config,
                       solve_fn=solve_fn, solver_state0=solver_state0,
                       quality_lin_fn=quality_lin_fn)

    return run


def lm_solve_dist(
    mesh,
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
    *,
    aruco_size: float,
    config: LMConfig = LMConfig(),
):
    """Distributed lm_solve: same contract as solve.lm.lm_solve (arrays in
    original tag numbering, any placement); tags and their observations are
    sharded internally and results return in the original numbering."""
    n_caps = np.asarray(cap_poses).shape[0]
    n_tags = np.asarray(tag_poses).shape[0]
    prob = TagShardedProblem(mesh, cap_idx, tag_idx, corners, block_mask,
                             n_tags)
    tag_poses_s = prob.put_tags(tag_poses)
    tag_active_s = prob.put_tag_mask(tag_active)
    bm = prob.block_mask(np.asarray(block_mask))
    camera_r, cap_poses_r, cam_a, cap_a = prob.put_rep(
        camera, cap_poses, cam_active, cap_active
    )

    run = _dist_lm_runner(mesh, prob.t_per, n_caps, aruco_size, config,
                          prob.obs_per_tag, prob.obs_per_cap,
                          row_slots=prob.row_slots,
                          shard_rows=prob.shard_rows,
                          shard_cap_rows=prob.shard_cap_rows)
    cam, caps, tags, info = run(
        camera_r, cap_poses_r, tag_poses_s, prob.cap_idx, prob.tag_idx,
        prob.corners, bm, cam_a, cap_a, tag_active_s,
    )
    tags_old = prob.tags_to_old(tags, n_tags)
    return cam, caps, jnp.asarray(tags_old), info


def make_dist_wave_solver(mesh, *, aruco_size: float, config: LMConfig,
                          seed_mode: str = "hybrid", obs_per_tag: int = 8,
                          obs_per_cap: int = 8, row_slots=None,
                          shard_rows=None, shard_cap_rows=None):
    """Jitted distributed wave solver (seeding prologue + LM) over the
    tag-sharded layout; all tag-indexed inputs/outputs use the RENUMBERED
    order (the runner owns the mapping).  Memoized so every _WaveRunner
    (one per solve/solve_incremental call) shares the jit cache — a serve
    loop must not re-trace per batch."""
    return _dist_wave_solver(mesh, aruco_size, config, seed_mode,
                             obs_per_tag, obs_per_cap, row_slots,
                             shard_rows, shard_cap_rows)


@lru_cache(maxsize=32)
def _dist_wave_solver(mesh, aruco_size, config, seed_mode, obs_per_tag,
                      obs_per_cap, row_slots=None, shard_rows=None,
                      shard_cap_rows=None):
    @jax.jit
    def run(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
            block_mask, cam_active, cap_active, tag_active,
            seed_cap, seed_block, tag_init_blocks, anchor_rows, anchor_mask,
            lm_enabled=True, iter_budget=None):
        from arslam.solve.batch import apply_wave_seeds

        n_caps = cap_poses.shape[0]
        t_new = tag_poses.shape[0]
        n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        t_per = t_new // n_dev
        # seeds apply on the ORIGINAL repacked table (tag_init_blocks holds
        # row indices into it); grouping follows
        cap_poses, tag_poses = apply_wave_seeds(
            camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
            seed_cap, seed_block, tag_init_blocks, anchor_rows, anchor_mask,
            aruco_size, seed_mode,
        )
        make_group, make_lin, make_quality, make_quality_lin, make_solve = (
            make_tag_sharded_hooks(
                mesh, t_per, n_caps, aruco_size, config.jacobi_scaling,
                config.enable_distortion, obs_per_tag, obs_per_cap,
                loss=config.loss, loss_scale=config.loss_scale,
                linear_solver=config.linear_solver,
                cg_tol=config.cg_tolerance,
                cg_iters=config.cg_max_iterations, row_slots=row_slots,
                shard_rows=shard_rows, shard_cap_rows=shard_cap_rows,
            )
        )
        grouped = make_group(cap_idx, tag_idx, corners, block_mask)
        lin_fn = make_lin(*grouped)
        quality_fn = make_quality(*grouped)
        quality_lin_fn = make_quality_lin(*grouped)
        solve_fn = make_solve(cam_active, cap_active, tag_active, grouped)
        solver_state0 = None
        if config.linear_solver == "cg":
            solver_state0 = jnp.zeros(3 + 6 * n_caps, cap_poses.dtype)
        return lm_core(camera, cap_poses, tag_poses, cam_active, cap_active,
                       tag_active, lin_fn, quality_fn, config,
                       enabled=lm_enabled, solve_fn=solve_fn,
                       solver_state0=solver_state0,
                       quality_lin_fn=quality_lin_fn,
                       iter_budget=iter_budget)

    return run
