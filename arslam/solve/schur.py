"""Gauss–Newton normal equations with Schur elimination of tag blocks.

The device replacement for ceres' DENSE_SCHUR linear solver
(ar_slam_util.cpp:1011): tag (landmark) 6x6 blocks are eliminated first —
they are conditionally independent given the cameras — leaving a dense
reduced system over [camera(3); capture poses(6C)] that maps onto dense
matmuls.

Everything here is shape-static over the padded problem
(C_pad caps, T_pad tags, B_pad blocks) and fully differentiable-free (only
linear algebra), so it jits once per bucket size.

Layout notes:
- The reduced vector is x = [cam(3), cap_0(6), cap_1(6), ...] of length
  Nr = 3 + 6*C_pad.
- W (cap/cam × tag coupling) is materialized dense [Nr, 6*T_pad] by reshape
  of per-(cap,tag) segment sums — no scatter in the hot path except the
  block-diagonal placement of the per-capture 6x6 blocks.
- Per-tag 6x6 inverses are batched; S = A - W V^{-1} W^T is one batched
  einsum + a dense Cholesky solve.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.ops import segment_sum

# f32 products that feed an LM step run at full f32: a default-precision
# dot may round its inputs (TF32 on an H100: 2.8e-4 relative error on a
# 2048² matmul vs 2.1e-6 pinned), which drifts the flat focal/depth
# direction of a map (H100, rendered 48-capture map: focal error 0.36 %
# unpinned vs 0.06 % pinned)
_HP = jax.lax.Precision.HIGHEST


def spd_inv(a, n: int):
    """Batched (..., n, n) SPD inverse via fully UNROLLED Cholesky →
    triangular inverse → L⁻ᵀL⁻¹.  The damped 6×6 tag blocks and the
    SCHUR_JACOBI preconditioner blocks are inverted every LM iteration;
    ``jnp.linalg.inv`` lowers to a LAPACK-style LU custom call per
    batch — the unrolled form is plain elementwise code XLA fuses to a
    handful of kernels.  Inputs must
    be SPD-intended (ours are Jacobi-scaled + λ-damped, inactive slots
    pinned to identity) but may be MARGINALLY indefinite in f32 (the
    SCHUR_JACOBI blocks are a near-cancelling hpp − dg_p; at 10k-tag
    scale some blocks lose definiteness to rounding).  MODIFIED Cholesky:
    every pivot is floored at 1e-6× the block's LARGEST diagonal entry,
    so even a fully collapsed pivot yields an inverse bounded by ~1e6/σ
    relative to the block's scale (an absolute 1e-30 floor produced
    ~1e15-scale garbage inverses that made LM reject every step at 10k
    tags; LU-with-pivoting degraded gracefully — this floor restores
    that behavior at Cholesky cost)."""
    diag_max = a[..., 0, 0]
    for i in range(1, n):
        diag_max = jnp.maximum(diag_max, a[..., i, i])
    floor = 1e-6 * jnp.abs(diag_max) + 1e-30
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        floor_i = floor
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, floor_i))
            else:
                L[i][j] = s / L[j][j]
    linv = [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(j, n):
            if i == j:
                linv[i][j] = 1.0 / L[i][i]
            else:
                s = L[i][j] * linv[j][j]
                for k in range(j + 1, i):
                    s = s + L[i][k] * linv[k][j]
                linv[i][j] = -s / L[i][i]
    rows = []
    for i in range(n):
        cols = []
        for j in range(n):
            s = None
            for k in range(max(i, j), n):
                term = linv[k][i] * linv[k][j]
                s = term if s is None else s + term
            cols.append(s)
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


class NormalEqs(NamedTuple):
    """Assembled blocks of J^T J and J^T r, pre-damping/scaling."""

    hcc: jnp.ndarray  # (3, 3) cam-cam
    hcp: jnp.ndarray  # (C, 3, 6) cam-cap
    hpp: jnp.ndarray  # (C, 6, 6) cap-cap diag blocks
    hct: jnp.ndarray  # (T, 3, 6) cam-tag
    hpt: jnp.ndarray  # (6C, 6T) cap-tag coupling, flat (block-sparse scatter)
    htt: jnp.ndarray  # (T, 6, 6) tag-tag diag blocks
    g_c: jnp.ndarray  # (3,)
    g_p: jnp.ndarray  # (C, 6)
    g_t: jnp.ndarray  # (T, 6)


class CapEqs(NamedTuple):
    """Camera/capture-side blocks only (the small, replicated part in the
    tag-sharded distributed solver)."""

    hcc: jnp.ndarray  # (3, 3)
    hcp: jnp.ndarray  # (C, 3, 6)
    hpp: jnp.ndarray  # (C, 6, 6)
    g_c: jnp.ndarray  # (3,)
    g_p: jnp.ndarray  # (C, 6)


def _outer_rsum(a, b):
    """Per-block matrix product Σ_r a[b,r,i]·b[b,r,j] as a broadcast-
    multiply + reduce, NOT einsum: a dot_general may run at reduced
    precision by default (bf16 / TF32 matrix units) — enough to stall LM
    recovery well above the exact form's floor — and its tiny-trailing-
    dim operands pad badly (see assemble_grouped).  The reduce fusion is
    exact f32 elementwise code."""
    return (a[:, :, :, None] * b[:, :, None, :]).sum(axis=1)


def assemble_cap_side(r, jc, jp, cap_idx, n_caps):
    """Camera/capture blocks of J^T J and J^T r (additive over blocks —
    these are the SMALL psum in the distributed solver)."""
    hcc = _outer_rsum(jc, jc).sum(axis=0)
    hcp = segment_sum(_outer_rsum(jc, jp), cap_idx, num_segments=n_caps)
    hpp = segment_sum(_outer_rsum(jp, jp), cap_idx, num_segments=n_caps)
    g_c = (jc * r[:, :, None]).sum(axis=(0, 1))
    g_p = segment_sum((jp * r[:, :, None]).sum(axis=1), cap_idx,
                      num_segments=n_caps)
    return CapEqs(hcc, hcp, hpp, g_c, g_p)


def assemble_tag_side(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags):
    """Tag-indexed blocks of J^T J and J^T r.  With blocks partitioned BY
    TAG these never leave the tag's shard (no psum): all of a tag's
    observations assemble locally."""
    hct = segment_sum(_outer_rsum(jc, jt), tag_idx, num_segments=n_tags)
    # cap-tag coupling scattered straight into the flat (6C, 6T) matrix —
    # each (capture, tag) pair appears in at most one block, so this is a
    # pure scatter-add with no dense (C, T) intermediate.
    hpt_b = _outer_rsum(jp, jt)  # (B, 6, 6)
    six = jnp.arange(6)
    rows = cap_idx[:, None, None] * 6 + six[None, :, None]  # (B, 6, 6)
    cols = tag_idx[:, None, None] * 6 + six[None, None, :]
    hpt = jnp.zeros((6 * n_caps, 6 * n_tags), dtype=jc.dtype)
    hpt = hpt.at[jnp.broadcast_to(rows, hpt_b.shape),
                 jnp.broadcast_to(cols, hpt_b.shape)].add(hpt_b)
    # htt gets damped + inverted; the exact elementwise products keep PD
    # under damping (the einsum form needed Precision.HIGHEST for this)
    htt = segment_sum(_outer_rsum(jt, jt), tag_idx, num_segments=n_tags)
    g_t = segment_sum((jt * r[:, :, None]).sum(axis=1), tag_idx,
                      num_segments=n_tags)
    return hct, hpt, htt, g_t


class GroupedEqs(NamedTuple):
    """Normal-equation blocks in the CAPTURE-SPARSE tag-grouped layout.

    The cap/tag coupling is stored as per-observation 6x6 blocks ``wt_s``
    (T, S, 6, 6) — slot (t, s) couples tag t with capture
    ``slot_cap[t*S+s]`` — NOT as the dense (T, 3+6C, 6) slab of round 1.
    Each tag observes at most S captures, so the slab was almost entirely
    structural zeros; the sparse layout is O(blocks) memory (~36 floats per
    observation) and keeps a 10k-tag / 4k-capture problem in HBM where the
    slab (~5.8 GB) could not fit.  ``slot_cap`` is carried by the caller
    (it is static per solve), not in the tuple.

    Field names of the camera/capture blocks match NormalEqs so
    cap_scale_vectors / reduced_solve work on either."""

    hcc: jnp.ndarray  # (3, 3)
    hcp: jnp.ndarray  # (C, 3, 6)
    hpp: jnp.ndarray  # (C, 6, 6)
    hct: jnp.ndarray  # (T, 3, 6) cam-tag coupling
    wt_s: jnp.ndarray  # (T, S, 6, 6) capture-sparse cap-tag coupling
    htt: jnp.ndarray  # (T, 6, 6)
    g_c: jnp.ndarray  # (3,)
    g_p: jnp.ndarray  # (C, 6)
    g_t: jnp.ndarray  # (T, 6)


def group_blocks_by_tag(tag_idx, block_mask, n_tags: int, s_max: int):
    """Device-side grouping of a block table into (N, S) key slots.

    Generic over the key: pass ``tag_idx`` to group by tag (the primary
    layout) or a capture index to build the capture-grouped permutation the
    sparse assembly uses for capture-side reductions.

    Returns (gather (N*S,) int32 source rows, mask (N*S,) bool).  Runs ONCE
    per solve (outside the LM loop); blocks beyond ``s_max`` observations of
    one key are dropped — callers must size s_max to the true maximum.

    This is the ONLY scatter in the grouped pipeline, amortized over all
    LM iterations (the flat pipeline re-pays a (6C, 6T) scatter every
    relinearization).
    """
    b = tag_idx.shape[0]
    key = jnp.where(block_mask, tag_idx, n_tags).astype(jnp.int32)
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    sk = key[order]
    pos = jnp.arange(b, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    start_pos = jax.lax.cummax(jnp.where(is_start, pos, -1))
    slot = pos - start_pos
    valid = (sk < n_tags) & (slot < s_max)
    dest = jnp.where(valid, sk * s_max + slot, n_tags * s_max)  # OOB drops
    gather = jnp.zeros((n_tags * s_max,), jnp.int32)
    gather = gather.at[dest].set(order, mode="drop")
    mask = jnp.zeros((n_tags * s_max,), bool).at[dest].set(True, mode="drop")
    return gather, mask


class TagRows(NamedTuple):
    """ROW-SPLIT layout context: the tag-grouped slot table is (R, S_row)
    with a tag spanning ``ceil(obs_t / S_row)`` consecutive rows, instead
    of one (T, S_max) row per tag.

    Why: the rectangular (T, S_max) table is sized by the MOST-observed
    tag while the mean is far lower (1.87x padding on the 10k-tag / 4k-
    capture benchmark — padding multiplies relinearization, assembly and
    every CG matvec).  Row splitting with a small fixed S_row packs slots
    at ~1.1-1.25x.  Per-tag quantities (V blocks, scales, gradients) stay
    (T, ...); per-row partial sums reduce to tags by gathering each tag's
    ≤ max_rows rows (static bound) and reshape-summing — gathers, never
    scatters, in the hot path.

    Fields (R = row budget, static):
      row_tag: (R,) int32 owning tag per row, clipped to [0, T-1]
               (use row_valid to mask padding rows)
      row_valid: (R,) bool
      tag_rows: (T, max_rows) int32 row ids per tag (clamped in-range)
      tag_rows_mask: (T, max_rows) bool
    """

    row_tag: jnp.ndarray
    row_valid: jnp.ndarray
    tag_rows: jnp.ndarray
    tag_rows_mask: jnp.ndarray


def group_blocks_by_tag_rows(tag_idx, block_mask, n_tags: int, s_row: int,
                             n_rows: int, max_rows: int):
    """Row-split variant of group_blocks_by_tag: sort blocks by tag, then
    assign each tag's k-th observation to row ``row_base[tag] + k // s_row``
    slot ``k % s_row``.  Returns (gather (n_rows*s_row,), mask, TagRows).

    Runs ONCE per solve.  Blocks overflowing the ``n_rows`` budget are
    dropped — callers must size n_rows ≥ Σ_t ceil(obs_t / s_row); max_rows
    must be ≥ ceil(max_t obs_t / s_row)."""
    b = tag_idx.shape[0]
    key = jnp.where(block_mask, tag_idx, n_tags).astype(jnp.int32)
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    sk = key[order]
    pos = jnp.arange(b, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    start_pos = jax.lax.cummax(jnp.where(is_start, pos, -1))
    slot_in_tag = pos - start_pos
    counts = jnp.zeros((n_tags,), jnp.int32).at[sk].add(
        (sk < n_tags).astype(jnp.int32), mode="drop")
    rows_per = -(-counts // s_row)
    row_base = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(rows_per)])  # (T+1,)
    total_rows = row_base[n_tags]
    skc = jnp.clip(sk, 0, n_tags - 1)
    dest_row = row_base[skc] + slot_in_tag // s_row
    valid = (sk < n_tags) & (dest_row < n_rows)
    dest = jnp.where(valid, dest_row * s_row + slot_in_tag % s_row,
                     n_rows * s_row)
    gather = jnp.zeros((n_rows * s_row,), jnp.int32)
    gather = gather.at[dest].set(order, mode="drop")
    mask = jnp.zeros((n_rows * s_row,), bool).at[dest].set(True, mode="drop")
    r_ids = jnp.arange(n_rows, dtype=jnp.int32)
    row_tag = jnp.searchsorted(row_base[1:], r_ids,
                               side="right").astype(jnp.int32)
    row_valid = r_ids < total_rows
    row_tag = jnp.clip(row_tag, 0, n_tags - 1)
    mr = jnp.arange(max_rows, dtype=jnp.int32)
    tag_rows_mask = mr[None, :] < rows_per[:, None]
    tag_rows = jnp.clip(row_base[:n_tags, None] + mr[None, :], 0, n_rows - 1)
    return gather, mask, TagRows(row_tag, row_valid, tag_rows, tag_rows_mask)


def rows_to_tags(x_rows, rows: TagRows):
    """Sum per-row values (R, ...) into their tags (T, ...): gather each
    tag's ≤ max_rows rows (static) and reshape-sum — the scatter-free
    row→tag reduction used in assembly, each CG matvec and back-subst."""
    g = x_rows[rows.tag_rows]  # (T, max_rows, ...)
    m = rows.tag_rows_mask
    m = m.reshape(m.shape + (1,) * (g.ndim - 2)).astype(x_rows.dtype)
    return (g * m).sum(axis=1)


def tags_to_rows(x_tags, rows: TagRows):
    """Expand per-tag values (T, ...) to rows (R, ...) (clipped gather;
    padding rows carry tag 0's values — always masked downstream by the
    zero coupling blocks of invalid slots)."""
    return x_tags[rows.row_tag]


def assemble_grouped(r, jc, jp, jt, cap_gather, cap_gmask, n_caps: int,
                     n_tags: int, s_max: int,
                     rows: TagRows | None = None,
                     cap_rows: TagRows | None = None) -> GroupedEqs:
    """Assemble normal equations from a TAG-GROUPED block table — zero
    segment ops, zero scatters, zero one-hot expansions in the hot path.

    Inputs are (T*S, ...) with row t*S+s belonging to tag t (masked rows
    zero).  Tag-side blocks reduce by plain reshape-sums.  Capture-side
    blocks reduce the same way through the CAPTURE-GROUPED permutation
    ``cap_gather``/``cap_gmask`` (from ``group_blocks_by_tag`` keyed on the
    grouped capture index): gather the per-block products into capture
    order, then reshape-sum.  This replaces round 1's {0,1} one-hot
    routing matmuls: the gather route adds exactly (no
    HIGHEST-precision pinning needed), and is O(blocks) memory where the
    (B, C) one-hot was itself a wall at 10k tags / 4k captures (~4 GB).

    The cap/tag coupling stays capture-sparse as per-slot blocks ``wt_s``
    (T, S, 6, 6) — the dense (T, 3+6C, 6) slab is never built here (the
    dense reduced solve expands a transient one; CG never does).
    """
    dtype = r.dtype
    lead_c = n_caps if cap_rows is None else cap_rows.row_tag.shape[0]
    sc = cap_gather.shape[0] // lead_c
    mc = cap_gmask.astype(dtype)

    hcc = jnp.einsum("bri,brj->ij", jc, jc, precision=_HP)
    g_c = jnp.einsum("bri,br->i", jc, r, precision=_HP)
    # capture-side blocks: gather per-block products into capture order and
    # reshape-sum (per capture, or per capture-ROW then rows→captures — the
    # capture table row-splits exactly like the tag table).  Padding gather
    # slots read row 0 of a REAL block, so they must be masked before the
    # sum.  The three products ride ONE fused (B, 60) gather instead of
    # three same-indexed gathers.
    # Products are broadcast-multiply + reduce, not einsum: a dot_general
    # over the tiny trailing dims materializes padded (B, 6, 6) buffers
    # and may round its operands; the reduce fusions keep the block axis
    # minor and stay exact f32.
    b_rows = r.shape[0]
    cat = jnp.concatenate([
        (jc[:, :, :, None] * jp[:, :, None, :]).sum(axis=1).reshape(
            b_rows, 18),
        (jp[:, :, :, None] * jp[:, :, None, :]).sum(axis=1).reshape(
            b_rows, 36),
        (jp * r[:, :, None]).sum(axis=1),
    ], axis=1)  # (B, 60)
    per = (cat[cap_gather] * mc[:, None]).reshape(lead_c, sc, 60).sum(axis=1)
    if cap_rows is not None:
        per = rows_to_tags(per, cap_rows)
    hcp = per[:, :18].reshape(-1, 3, 6)
    hpp = per[:, 18:54].reshape(-1, 6, 6)
    g_p = per[:, 54:]

    # leading axis of the slot table: tags (rows=None) or split rows;
    # in the row-split layout the per-row partial sums reduce to tags by
    # the static tag→rows gather (rows_to_tags) — still scatter-free.
    #
    # The tag-side products are BROADCAST-MULTIPLY + REDUCE, not einsum:
    # a dot_general whose operands trail in the tiny (8, 6) / (6, 6) dims
    # pads those dims to the matrix-unit tile, while reduce fusions keep
    # the BLOCK axis minor and never materialize the (B, 8, 6, 6)
    # products.  They are also exact f32 — htt is the block that gets
    # INVERTED (damped V), where reduced-precision product noise can
    # exceed the LM damping, flip blocks indefinite and reject every step
    # at 10k-tag scale; an einsum would need Precision.HIGHEST for that,
    # the reduce form is exact by construction.
    lead = r.shape[0] // s_max
    jt_r = jt.reshape(lead, s_max * 8, 6)
    jc_r = jc.reshape(lead, s_max * 8, 3)
    r_r = r.reshape(lead, s_max * 8)
    hct = (jc_r[:, :, :, None] * jt_r[:, :, None, :]).sum(axis=1)
    htt = (jt_r[:, :, :, None] * jt_r[:, :, None, :]).sum(axis=1)
    g_t = (jt_r * r_r[:, :, None]).sum(axis=1)
    if rows is not None:
        hct = rows_to_tags(hct, rows)
        htt = rows_to_tags(htt, rows)
        g_t = rows_to_tags(g_t, rows)

    wt_s = (jp[:, :, :, None] * jt[:, :, None, :]).sum(axis=1).reshape(
        lead, s_max, 6, 6)
    return GroupedEqs(hcc, hcp, hpp, hct, wt_s, htt, g_c, g_p, g_t)


def quad_form_flat(eqs: NormalEqs, d_cam, d_cap, d_tag):
    """(d^T g, d^T H d) straight from the assembled normal equations.

    The LM step-quality test needs g_dot_d = d^T J^T r and
    jd_sq = ||J d||^2 = d^T (J^T J) d; both are already encoded in the
    assembled (undamped, unscaled) blocks, so the per-block Jacobian table
    never has to be carried in the LM loop state for them — that carry
    (plus its speculative twin at the accept-select) was the largest
    per-block array in the 40k-tag HBM budget.  HIGHEST precision: these
    are O(params) reductions (negligible next to a relinearization) and
    model_decrease = -d^T g - 0.5 d^T H d is a cancelling subtraction.
    """
    hp = jax.lax.Precision.HIGHEST
    g_dot_d = (jnp.dot(eqs.g_c, d_cam, precision=hp)
               + jnp.sum(eqs.g_p * d_cap)
               + jnp.sum(eqs.g_t * d_tag))
    quad = (
        jnp.einsum("ij,i,j->", eqs.hcc, d_cam, d_cam, precision=hp)
        + 2.0 * jnp.einsum("cij,i,cj->", eqs.hcp, d_cam, d_cap,
                           precision=hp)
        + jnp.einsum("cij,ci,cj->", eqs.hpp, d_cap, d_cap, precision=hp)
        + 2.0 * jnp.einsum("tij,i,tj->", eqs.hct, d_cam, d_tag,
                           precision=hp)
        + 2.0 * jnp.dot(d_cap.reshape(-1),
                        jnp.dot(eqs.hpt, d_tag.reshape(-1), precision=hp),
                        precision=hp)
        + jnp.einsum("tij,ti,tj->", eqs.htt, d_tag, d_tag, precision=hp)
    )
    return g_dot_d, quad


def quad_form_cap_side(hcc, hcp, hpp, g_c, g_p, d_cam, d_cap):
    """Camera/capture contribution to (d^T g, d^T H d) — replicated in the
    tag-sharded solver (no psum needed)."""
    hp = jax.lax.Precision.HIGHEST
    g_dot_d = jnp.dot(g_c, d_cam, precision=hp) + jnp.sum(g_p * d_cap)
    quad = (
        jnp.einsum("ij,i,j->", hcc, d_cam, d_cam, precision=hp)
        + 2.0 * jnp.einsum("cij,i,cj->", hcp, d_cam, d_cap, precision=hp)
        + jnp.einsum("cij,ci,cj->", hpp, d_cap, d_cap, precision=hp)
    )
    return g_dot_d, quad


def quad_form_tag_side(hct, wt_s, htt, g_t, slot_cap, d_cam, d_cap, d_tag,
                       rows: TagRows | None = None):
    """Tag-indexed contribution to (d^T g, d^T H d) — additive over tag
    shards (each shard computes its tags' partial; psum the two scalars).

    ``slot_cap`` is the flat per-slot capture index; padding slots carry
    zero coupling blocks, so their (real) capture / clipped tag reads
    contribute nothing.  With ``rows`` set, the wt_s leading axis is split
    rows and d_tag expands via row_tag.
    """
    hp = jax.lax.Precision.HIGHEST
    lead, s_max = wt_s.shape[:2]
    d_tag_rows = tags_to_rows(d_tag, rows) if rows is not None else d_tag
    dcap_s = d_cap[slot_cap].reshape(lead, s_max, 6)
    g_dot_d = jnp.sum(g_t * d_tag)
    quad = (
        2.0 * jnp.einsum("tij,i,tj->", hct, d_cam, d_tag, precision=hp)
        # broadcast-reduce, not einsum: a (·,6,6)-trailing dot_general
        # operand pads 21x under T(8,128) (see assemble_grouped)
        + 2.0 * jnp.sum(wt_s * dcap_s[:, :, :, None]
                        * d_tag_rows[:, None, None, :])
        + jnp.einsum("tij,ti,tj->", htt, d_tag, d_tag, precision=hp)
    )
    return g_dot_d, quad


def quad_form_grouped(eqs: GroupedEqs, slot_cap, d_cam, d_cap, d_tag,
                      rows: TagRows | None = None):
    """(d^T g, d^T H d) for the capture-sparse grouped layout.
    See quad_form_flat for why this replaces the carried Jacobian table."""
    gd_c, q_c = quad_form_cap_side(eqs.hcc, eqs.hcp, eqs.hpp, eqs.g_c,
                                   eqs.g_p, d_cam, d_cap)
    gd_t, q_t = quad_form_tag_side(eqs.hct, eqs.wt_s, eqs.htt, eqs.g_t,
                                   slot_cap, d_cam, d_cap, d_tag, rows=rows)
    return gd_c + gd_t, q_c + q_t


def _scale_and_damp_tags(hct, wt_s, slot_cap, htt, g_t, s_c, s_p, tag_active,
                         lam, jacobi_scaling: bool = True,
                         min_diag: float = 1e-6, max_diag: float = 1e32,
                         rows: TagRows | None = None):
    """Shared prologue of the grouped eliminations: Jacobi-scale the sparse
    coupling blocks / tag blocks / tag gradients, damp V, batch-invert.
    ``slot_cap`` (T*S,) maps each coupling slot to its capture (row scales
    gather through it).  Returns (hct_s, wt_ss, v_inv, g_t_scaled, s_t).
    With ``rows`` the coupling table wt_s is row-split (R, S_row, 6, 6);
    everything per-tag stays (T, ...)."""
    dtype = htt.dtype
    lead, s_max = wt_s.shape[:2]
    tag_m = tag_active.astype(dtype)

    d_t = jnp.diagonal(htt, axis1=-2, axis2=-1)  # (t, 6)
    if jacobi_scaling:
        s_t = tag_m[:, None] / (1.0 + jnp.sqrt(jnp.maximum(d_t, 0.0)))
    else:
        s_t = jnp.broadcast_to(tag_m[:, None], d_t.shape)

    hct_s = hct * s_c[None, :, None] * s_t[:, None, :]
    sp_slot = s_p[slot_cap].reshape(lead, s_max, 6)
    s_t_rows = s_t if rows is None else tags_to_rows(s_t, rows)
    wt_ss = wt_s * sp_slot[:, :, :, None] * s_t_rows[:, None, None, :]
    htt = htt * s_t[:, :, None] * s_t[:, None, :]
    g_t = g_t * s_t

    dd_t = jnp.clip(jnp.diagonal(htt, axis1=-2, axis2=-1), min_diag, max_diag)
    eye6 = jnp.eye(6, dtype=dtype)
    htt = htt + lam * dd_t[:, :, None] * eye6
    htt = jnp.where(tag_m[:, None, None] > 0, htt, eye6)

    v_inv = spd_inv(htt, 6)  # (t, 6, 6), batched
    return hct_s, wt_ss, v_inv, g_t, s_t


def expand_coupling_slab(hct_s, wt_ss, slot_cap, n_caps: int):
    """Expand the capture-sparse coupling into the dense (T, Nr, 6) slab —
    TRANSIENT, used only by the dense reduced solve (the slab no longer
    lives in the LM loop state; CG never builds it).  Routing is a {0,1}
    one-hot contraction of already-scaled values; HIGHEST precision keeps it
    a pure routing (bf16 rounding would perturb H)."""
    n_tags, s_max = wt_ss.shape[:2]
    oc = (slot_cap.reshape(n_tags, s_max)[:, :, None]
          == jnp.arange(n_caps, dtype=jnp.int32)[None, None, :]
          ).astype(wt_ss.dtype)  # (T, S, C); masked slots carry zero blocks
    wt_pp = jnp.einsum("tsc,tsij->tcij", oc, wt_ss,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.concatenate(
        [hct_s, wt_pp.reshape(n_tags, 6 * n_caps, 6)], axis=1)


def eliminate_tags_grouped(hct, wt_s, slot_cap, htt, g_t, s_c, s_p,
                           tag_active, lam, jacobi_scaling: bool = True,
                           min_diag: float = 1e-6, max_diag: float = 1e32):
    """Schur-eliminate tag blocks from the capture-sparse coupling.  Same
    math as eliminate_tags; the dense (T, Nr, 6) slab exists only as a
    transient inside this call (the dense reduced system is (Nr, Nr) anyway,
    so the dense path's memory is already O(Nr^2)).

    Returns (wvw, wvg, ctx) with wvw/wvg ADDITIVE over tag shards and
    ctx = (v_inv, hct_s, wt_ss, g_t_scaled, s_t) the (sparse) state
    back-substitution needs.
    """
    hct_s, wt_ss, v_inv, g_t, s_t = _scale_and_damp_tags(
        hct, wt_s, slot_cap, htt, g_t, s_c, s_p, tag_active, lam,
        jacobi_scaling, min_diag, max_diag,
    )
    wt = expand_coupling_slab(hct_s, wt_ss, slot_cap, s_p.shape[0])
    y = jnp.einsum("tnk,tkj->tnj", wt, v_inv, precision=_HP)  # (t, Nr, 6)
    # (Nr, Nr) and (Nr,), additive over shards
    wvw = jnp.einsum("tnk,tmk->nm", y, wt, precision=_HP)
    wvg = jnp.einsum("tnk,tk->n", y, g_t, precision=_HP)
    return wvw, wvg, (v_inv, hct_s, wt_ss, g_t, s_t)


def _cap_scatter(per_slot, cap_gather, cap_gmask, n_caps: int,
                 cap_rows: TagRows | None = None):
    """Sum per-slot values (T*S, ...) into their captures (C, ...) via the
    capture-grouped permutation — the scatter-free W·z reduction.  With
    ``cap_rows`` the permutation is capture-ROW-split (smaller gather,
    ~1.1x padding) and the per-row sums gather-reduce to captures."""
    lead_c = n_caps if cap_rows is None else cap_rows.row_tag.shape[0]
    sc = cap_gather.shape[0] // lead_c
    trailing = per_slot.shape[1:]
    mc = cap_gmask.astype(per_slot.dtype)
    g = per_slot[cap_gather] * mc.reshape((-1,) + (1,) * len(trailing))
    per = g.reshape((lead_c, sc) + trailing).sum(axis=1)
    return per if cap_rows is None else rows_to_tags(per, cap_rows)


def schur_solve_grouped_cg(eqs: GroupedEqs, slot_cap, cap_gather, cap_gmask,
                           lam, cam_active, cap_active, tag_active,
                           jacobi_scaling: bool = True,
                           min_diag: float = 1e-6, max_diag: float = 1e32,
                           cg_tol: float = 1e-2, cg_iters: int = 100,
                           x0=None, reduce_fn=None,
                           rows: TagRows | None = None,
                           cap_rows: TagRows | None = None):
    """ITERATIVE_SCHUR analogue: preconditioned CG on the reduced camera
    system with an IMPLICIT, CAPTURE-SPARSE Schur complement.

    ``x0`` optionally warm-starts CG (the previous LM iteration's reduced
    solution — consecutive damped systems are close, so this cuts CG
    iterations substantially).  Returns (d_cam, d_cap, d_tag, delta_r).

    Nothing dense in T×C is ever formed: each CG step applies
    S·v = A·v − W (V⁻¹ (Wᵀ v)) against the per-slot 6x6 blocks in
    O(blocks·36) flops — Wᵀv gathers capture rows by ``slot_cap`` and
    reshape-sums per tag; W·z routes per-slot products back through the
    capture-grouped permutation.  Peak memory is O(blocks), so a
    10k-tag / 4k-capture problem fits one chip (the round-1 slab did not).
    Preconditioner: SCHUR_JACOBI — the exact block diagonal of S (damped
    camera/capture blocks minus the per-slot tag corrections), batch
    inverted.  Inexact steps compose fine with the LM trust region (ceres
    ships the same combination as ITERATIVE_SCHUR).

    ``reduce_fn`` (list->list) all-reduces shard-additive values in the
    TAG-SHARDED distributed solver: once over the packed
    [preconditioner, rhs] at setup and once per CG matvec on the (Nr,)
    downdate — the per-step traffic is one psum of the reduced vector.
    Identity when None (single device).
    """
    dtype = eqs.hcc.dtype
    c = eqs.hpp.shape[0]
    lead, s_max = eqs.wt_s.shape[:2]  # (T, S_max) or row-split (R, S_row)
    n_tags = eqs.htt.shape[0]
    if reduce_fn is None:
        def reduce_fn(arrs):
            return arrs
    s_c, s_p = cap_scale_vectors(eqs, cam_active, cap_active, jacobi_scaling)
    hct_s, wt_ss, v_inv, g_t_s, s_t = _scale_and_damp_tags(
        eqs.hct, eqs.wt_s, slot_cap, eqs.htt, eqs.g_t, s_c, s_p, tag_active,
        lam, jacobi_scaling, min_diag, max_diag, rows=rows,
    )
    wt_flat = wt_ss.reshape(lead * s_max, 6, 6)

    def per_tag_sum(per_row):
        """(lead, ...) per-row partial sums → (T, ...)."""
        return per_row if rows is None else rows_to_tags(per_row, rows)

    def per_row_of_tag(per_tag):
        """(T, ...) → (lead, ...) expansion."""
        return per_tag if rows is None else tags_to_rows(per_tag, rows)

    cam_m = jnp.broadcast_to(cam_active, ()).astype(dtype)
    cap_m = cap_active.astype(dtype)
    m_r = jnp.concatenate(
        [jnp.broadcast_to(cam_m, (3,)), jnp.repeat(cap_m, 6)])

    hcc = eqs.hcc * s_c[:, None] * s_c[None, :]
    hcp = eqs.hcp * s_c[None, :, None] * s_p[:, None, :]
    hpp = eqs.hpp * s_p[:, :, None] * s_p[:, None, :]
    g_c = eqs.g_c * s_c
    g_p = eqs.g_p * s_p

    dd_c = jnp.clip(jnp.diagonal(hcc), min_diag, max_diag)
    dd_p = jnp.clip(jnp.diagonal(hpp, axis1=-2, axis2=-1), min_diag, max_diag)
    eye6 = jnp.eye(6, dtype=dtype)
    hcc = hcc + lam * jnp.diag(dd_c)
    hpp = hpp + lam * dd_p[:, :, None] * eye6

    # per-slot block products are broadcast-multiply + reduce, NOT einsum
    # (a (·,6,6)-trailing dot_general operand pads 21x under T(8,128) —
    # see the assemble_grouped note; these run every CG matvec over the
    # full block table, so a bad layout here is both the HBM peak and the
    # bandwidth bill)
    def wt_v(vc, vp):
        """Wᵀ v per tag: (T, 6) = hctᵀ vc + Σ_s wtᵀ vp[cap(slot)]."""
        u = jnp.einsum("tik,i->tk", hct_s, vc, precision=_HP)
        vp_slot = vp[slot_cap]  # (lead*S, 6) row gather
        u_slots = (wt_flat * vp_slot[:, :, None]).sum(axis=1)
        return u + per_tag_sum(u_slots.reshape(lead, s_max, 6).sum(axis=1))

    def w_z(z):
        """W z split into (cam (3,), cap (C, 6)) parts; cap part is the
        capture-grouped reshape-sum of per-slot products."""
        out_c = jnp.einsum("tik,tk->i", hct_s, z, precision=_HP)
        z_slot = jnp.repeat(per_row_of_tag(z), s_max, axis=0,
                            total_repeat_length=lead * s_max)
        per_slot = (wt_flat * z_slot[:, None, :]).sum(axis=2)  # (lead*S, 6)
        return out_c, _cap_scatter(per_slot, cap_gather, cap_gmask, c,
                                   cap_rows)

    def s_mv(v):
        vm = v * m_r
        vc = vm[:3]
        vp = vm[3:].reshape(c, 6)
        out_c = (jnp.matmul(hcc, vc, precision=_HP)
                 + jnp.einsum("cij,cj->i", hcp, vp, precision=_HP))
        out_p = (jnp.einsum("cij,i->cj", hcp, vc, precision=_HP)
                 + jnp.einsum("cij,cj->ci", hpp, vp, precision=_HP))
        u = wt_v(vc, vp)  # (T, 6), local to the tag shard
        z = jnp.einsum("tkj,tj->tk", v_inv, u, precision=_HP)
        down_c, down_p = w_z(z)  # shard-additive
        (down,) = reduce_fn(
            [jnp.concatenate([down_c, down_p.reshape(-1)])])
        av = jnp.concatenate([out_c, out_p.reshape(-1)]) - down
        return av * m_r + (1.0 - m_r) * v

    # rhs downdate W V^-1 g_t and the SCHUR_JACOBI preconditioner diagonal
    # corrections are all shard-additive: ONE packed reduce at setup.
    y_g = jnp.einsum("tkj,tj->tk", v_inv, g_t_s, precision=_HP)
    wvg_c, wvg_p = w_z(y_g)
    dg_c = jnp.einsum("tik,tkl,tjl->ij", hct_s, v_inv, hct_s,
                      precision=_HP)
    v_inv_slot = jnp.repeat(per_row_of_tag(v_inv), s_max, axis=0,
                            total_repeat_length=lead * s_max)
    # wt · v_inv · wtᵀ per slot, elementwise-reduce in two steps
    a_slot = (wt_flat[:, :, :, None] * v_inv_slot[:, None, :, :]).sum(axis=2)
    dg_slot = (a_slot[:, :, None, :] * wt_flat[:, None, :, :]).sum(axis=3)
    dg_p = _cap_scatter(dg_slot, cap_gather, cap_gmask, c, cap_rows)
    wvg_c, wvg_p, dg_c, dg_p = reduce_fn([wvg_c, wvg_p, dg_c, dg_p])

    g_r = jnp.concatenate([g_c, g_p.reshape(-1)])
    rhs = (-g_r + jnp.concatenate([wvg_c, wvg_p.reshape(-1)])) * m_r

    pc_c = hcc - dg_c
    pc_c = pc_c * cam_m + jnp.eye(3, dtype=dtype) * (1.0 - cam_m)
    pc_p = hpp - dg_p
    pc_p = jnp.where(cap_m[:, None, None] > 0, pc_p, eye6)
    # LU (not spd_inv) for the preconditioner: pc = hpp − dg is a
    # near-cancelling difference, and at 10k-tag scale f32 rounding
    # leaves some blocks STRONGLY indefinite — the Cholesky PSD
    # projection then distorts CG so badly that every LM step is
    # rejected, while the true (indefinite) LU inverse keeps CG-with-cap
    # effective.  Runs once per solve over C blocks, vs the T-block v_inv
    # where spd_inv's PD premise holds (htt is exact-assembled + damped).
    pc_c_inv = jnp.linalg.inv(pc_c)
    pc_p_inv = jnp.linalg.inv(pc_p)

    def m_inv(v):
        vc = jnp.matmul(pc_c_inv, v[:3], precision=_HP)
        vp = jnp.einsum("cij,cj->ci", pc_p_inv, v[3:].reshape(c, 6),
                        precision=_HP)
        return jnp.concatenate([vc, vp.reshape(-1)])

    delta_r, _ = jax.scipy.sparse.linalg.cg(
        s_mv, rhs, x0=x0, M=m_inv, tol=cg_tol, maxiter=cg_iters)
    delta_r = delta_r * m_r

    delta_cam = delta_r[0:3] * s_c
    delta_cap = delta_r[3:].reshape(c, 6) * s_p
    delta_tag = backsub_tags_sparse(v_inv, hct_s, wt_ss, slot_cap, g_t_s,
                                    s_t, tag_active, delta_r, rows=rows)
    return delta_cam, delta_cap, delta_tag, delta_r


def schur_solve_grouped(eqs: GroupedEqs, slot_cap, lam, cam_active,
                        cap_active, tag_active, jacobi_scaling: bool = True,
                        min_diag: float = 1e-6, max_diag: float = 1e32):
    """schur_solve over the grouped layout (same contract/return)."""
    s_c, s_p = cap_scale_vectors(eqs, cam_active, cap_active, jacobi_scaling)
    wvw, wvg, ctx = eliminate_tags_grouped(
        eqs.hct, eqs.wt_s, slot_cap, eqs.htt, eqs.g_t, s_c, s_p, tag_active,
        lam, jacobi_scaling, min_diag, max_diag,
    )
    delta_r, delta_cam, delta_cap = reduced_solve(
        eqs, s_c, s_p, cam_active, cap_active, lam, wvw, wvg,
        min_diag, max_diag,
    )
    v_inv, hct_s, wt_ss, g_t_s, s_t = ctx
    delta_tag = backsub_tags_sparse(v_inv, hct_s, wt_ss, slot_cap, g_t_s,
                                    s_t, tag_active, delta_r)
    return delta_cam, delta_cap, delta_tag


def assemble(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags) -> NormalEqs:
    """Segment-reduce per-block Jacobian products into H blocks.

    In the distributed solver each device assembles over its block shard;
    the capture-side blocks psum-reduce (small) while tag-side blocks stay
    on the tag's shard (blocks are partitioned by tag).
    """
    cap = assemble_cap_side(r, jc, jp, cap_idx, n_caps)
    hct, hpt, htt, g_t = assemble_tag_side(
        r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags
    )
    return NormalEqs(cap.hcc, cap.hcp, cap.hpp, hct, hpt, htt,
                     cap.g_c, cap.g_p, g_t)


def cap_scale_vectors(eqs: NormalEqs, cam_active, cap_active,
                      jacobi_scaling: bool = True):
    """Camera/capture Jacobi scale vectors with the active-masks folded in
    (s = mask / (1 + sqrt(diag(JtJ))), ceres convention).  Needs only the
    REPLICATED camera/capture diagonal blocks — in the tag-sharded
    distributed solver these come from one small psum."""
    dtype = eqs.hcc.dtype
    cam_m = jnp.broadcast_to(cam_active, ()).astype(dtype)
    cap_m = cap_active.astype(dtype)
    d_c = jnp.diagonal(eqs.hcc)
    d_p = jnp.diagonal(eqs.hpp, axis1=-2, axis2=-1)  # (C, 6)
    if jacobi_scaling:
        s_c = cam_m / (1.0 + jnp.sqrt(jnp.maximum(d_c, 0.0)))
        s_p = cap_m[:, None] / (1.0 + jnp.sqrt(jnp.maximum(d_p, 0.0)))
    else:
        s_c = jnp.broadcast_to(cam_m, d_c.shape)
        s_p = jnp.broadcast_to(cap_m[:, None], d_p.shape)
    return s_c, s_p


def eliminate_tags(hct, hpt, htt, g_t, s_c, s_p, tag_active, lam,
                   jacobi_scaling: bool = True,
                   min_diag: float = 1e-6, max_diag: float = 1e32):
    """Schur-eliminate a SET of tag blocks (all of them single-device; this
    shard's tags in the distributed solver).

    Per-tag work — damped 6x6 inverse, Y = W V^{-1}, the W V^{-1} W^T and
    W V^{-1} g_t contributions — involves only that tag's observations, so
    it is local to whichever device owns the tag; the returned ``wvw``
    (Nr, Nr) and ``wvg`` (Nr,) are ADDITIVE over tag shards (one psum
    replicates them).

    Returns (wvw, wvg, v_inv, wt, g_t_scaled, s_t) with tag-sharded
    leading axes for the last four (kept for back-substitution).
    """
    dtype = htt.dtype
    t = htt.shape[0]
    nr = 3 + s_p.size  # s_p is (C, 6) -> 3 + 6C
    tag_m = tag_active.astype(dtype)

    d_t = jnp.diagonal(htt, axis1=-2, axis2=-1)  # (t, 6)
    if jacobi_scaling:
        s_t = tag_m[:, None] / (1.0 + jnp.sqrt(jnp.maximum(d_t, 0.0)))
    else:
        s_t = jnp.broadcast_to(tag_m[:, None], d_t.shape)

    s_p_flat = s_p.reshape(-1)  # (6C,)
    s_t_flat = s_t.reshape(-1)  # (6t,)
    hct = hct * s_c[None, :, None] * s_t[:, None, :]
    hpt = hpt * s_p_flat[:, None] * s_t_flat[None, :]
    htt = htt * s_t[:, :, None] * s_t[:, None, :]
    g_t = g_t * s_t

    dd_t = jnp.clip(jnp.diagonal(htt, axis1=-2, axis2=-1), min_diag, max_diag)
    eye6 = jnp.eye(6, dtype=dtype)
    htt = htt + lam * dd_t[:, :, None] * eye6
    # Inactive tags get the identity so the batched inverse stays sane.
    htt = jnp.where(tag_m[:, None, None] > 0, htt, eye6)

    v_inv = spd_inv(htt, 6)  # (t, 6, 6), batched

    # W: [Nr, 6t] coupling of (cam, caps) to this shard's tags
    w_cam = hct.transpose(1, 0, 2).reshape(3, 6 * t)
    w = jnp.concatenate([w_cam, hpt], axis=0)  # (Nr, 6t)
    wt = w.reshape(nr, t, 6).transpose(1, 0, 2)  # (t, Nr, 6)

    y = jnp.einsum("tnk,tkj->tnj", wt, v_inv, precision=_HP)  # (t, Nr, 6)
    # (Nr, Nr) and (Nr,), additive over shards
    wvw = jnp.einsum("tnk,tmk->nm", y, wt, precision=_HP)
    wvg = jnp.einsum("tnk,tk->n", y, g_t, precision=_HP)
    return wvw, wvg, v_inv, wt, g_t, s_t


def reduced_solve(eqs: NormalEqs, s_c, s_p, cam_active, cap_active, lam,
                  wvw, wvg, min_diag: float = 1e-6, max_diag: float = 1e32):
    """Assemble and solve the damped reduced camera system
    S = A - sum(wvw); runs replicated (it is tiny: 3 + 6C unknowns)."""
    dtype = eqs.hcc.dtype
    C = eqs.hpp.shape[0]
    nr = 3 + 6 * C
    cam_m = jnp.broadcast_to(cam_active, ()).astype(dtype)
    cap_m = cap_active.astype(dtype)

    hcc = eqs.hcc * s_c[:, None] * s_c[None, :]
    hcp = eqs.hcp * s_c[None, :, None] * s_p[:, None, :]
    hpp = eqs.hpp * s_p[:, :, None] * s_p[:, None, :]
    g_c = eqs.g_c * s_c
    g_p = eqs.g_p * s_p

    dd_c = jnp.clip(jnp.diagonal(hcc), min_diag, max_diag)
    dd_p = jnp.clip(jnp.diagonal(hpp, axis1=-2, axis2=-1), min_diag, max_diag)
    eye6 = jnp.eye(6, dtype=dtype)
    hcc = hcc + lam * jnp.diag(dd_c)
    hpp = hpp + lam * dd_p[:, :, None] * eye6

    a = jnp.zeros((nr, nr), dtype=dtype)
    a = a.at[0:3, 0:3].set(hcc)
    hcp_flat = hcp.transpose(1, 0, 2).reshape(3, 6 * C)
    a = a.at[0:3, 3:].set(hcp_flat)
    a = a.at[3:, 0:3].set(hcp_flat.T)
    rows = 3 + (jnp.arange(C)[:, None, None] * 6 + jnp.arange(6)[None, :, None])
    cols = 3 + (jnp.arange(C)[:, None, None] * 6 + jnp.arange(6)[None, None, :])
    a = a.at[jnp.broadcast_to(rows, (C, 6, 6)),
             jnp.broadcast_to(cols, (C, 6, 6))].set(hpp)

    s_mat = a - wvw
    g_r = jnp.concatenate([g_c, g_p.reshape(-1)])
    rhs = -g_r + wvg

    # identity rows for inactive reduced params so Cholesky is well-posed
    m_r = jnp.concatenate(
        [jnp.broadcast_to(cam_m, (3,)), jnp.repeat(cap_m, 6)]
    )
    s_mat = s_mat * m_r[:, None] * m_r[None, :] + jnp.diag(1.0 - m_r)
    rhs = rhs * m_r

    cho = jax.scipy.linalg.cho_factor(s_mat)
    delta_r = jax.scipy.linalg.cho_solve(cho, rhs)
    delta_r = delta_r * m_r

    delta_cam = delta_r[0:3] * s_c
    delta_cap = delta_r[3:].reshape(C, 6) * s_p
    return delta_r, delta_cam, delta_cap


def backsub_tags_sparse(v_inv, hct_s, wt_ss, slot_cap, g_t_scaled, s_t,
                        tag_active, delta_r, rows: TagRows | None = None):
    """Back-substitute a tag shard from the capture-sparse coupling:
    delta_t = -V^{-1} (g_t + Wᵀ delta_r); Wᵀ delta_r gathers capture rows of
    delta_r by ``slot_cap`` and reshape-sums per tag — local to the shard
    that owns the tags.  ``rows``: wt_ss is row-split (R, S_row, 6, 6)."""
    lead, s_max = wt_ss.shape[:2]
    tag_m = tag_active.astype(v_inv.dtype)
    dc = delta_r[:3]
    dp = delta_r[3:].reshape(-1, 6)
    wtd = jnp.einsum("tik,i->tk", hct_s, dc, precision=_HP)
    dp_slot = dp[slot_cap]  # (lead*S, 6)
    per_slot = (wt_ss.reshape(lead * s_max, 6, 6)
                * dp_slot[:, :, None]).sum(axis=1)
    per_row = per_slot.reshape(lead, s_max, 6).sum(axis=1)
    wtd = wtd + (per_row if rows is None else rows_to_tags(per_row, rows))
    delta_t = -jnp.einsum("tkj,tj->tk", v_inv, g_t_scaled + wtd,
                          precision=_HP) * tag_m[:, None]
    return delta_t * s_t


def backsub_tags(v_inv, wt, g_t_scaled, s_t, tag_active, delta_r):
    """Back-substitute a tag shard: delta_t = -V^{-1} (g_t + W^T delta_r);
    local to the shard that owns the tags."""
    tag_m = tag_active.astype(v_inv.dtype)
    wtd = jnp.einsum("tnk,n->tk", wt, delta_r, precision=_HP)  # (t, 6)
    delta_t = -jnp.einsum("tkj,tj->tk", v_inv, g_t_scaled + wtd,
                          precision=_HP) * tag_m[:, None]
    return delta_t * s_t


def schur_solve(eqs: NormalEqs, lam, cam_active, cap_active, tag_active,
                jacobi_scaling: bool = True,
                min_diag: float = 1e-6, max_diag: float = 1e32):
    """Solve the damped normal equations (H + lam * clamp(diag)) delta = -g.

    Single-device composition of the stages (the distributed solver runs
    eliminate_tags/backsub_tags per tag shard with one psum of the
    additive (Nr, Nr) reduced contribution — see parallel/dist_lm.py).

    Args:
      eqs: assembled blocks.
      lam: LM damping parameter (scalar).
      cam_active: () bool — False freezes the camera block (localization
        mode, ≙ SetParameterBlockConstant at ar_slam_util.cpp:972).
      cap_active: (C,) bool mask of captures participating in this solve.
      tag_active: (T,) bool mask (False = frozen or padding,
        ≙ ar_slam_util.cpp:965).

    Returns:
      (delta_cam (3,), delta_cap (C, 6), delta_tag (T, 6))
    """
    s_c, s_p = cap_scale_vectors(eqs, cam_active, cap_active, jacobi_scaling)
    wvw, wvg, v_inv, wt, g_t_s, s_t = eliminate_tags(
        eqs.hct, eqs.hpt, eqs.htt, eqs.g_t, s_c, s_p, tag_active, lam,
        jacobi_scaling, min_diag, max_diag,
    )
    delta_r, delta_cam, delta_cap = reduced_solve(
        eqs, s_c, s_p, cam_active, cap_active, lam, wvw, wvg,
        min_diag, max_diag,
    )
    delta_tag = backsub_tags(v_inv, wt, g_t_s, s_t, tag_active, delta_r)
    return delta_cam, delta_cap, delta_tag
