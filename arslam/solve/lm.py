"""Levenberg–Marquardt trust-region driver (one jit, lax.while_loop).

The device replacement for ``ArSlamSolver::optimize`` / ceres::Solve
(ar_slam_util.cpp:1001-1018): the whole LM iteration — linearize, Schur
solve, step-quality gating, damping update — runs as a single compiled
device program with static shapes, so one optimize call is one host↔device
round trip regardless of iteration count.

Damping follows ceres' LM strategy: accept when the step-quality ratio
rho = actual_decrease / model_decrease exceeds min_relative_decrease;
on accept lam *= max(1/3, 1 - (2 rho - 1)^3), nu resets to 2; on reject
lam *= nu, nu doubles.

The loop body is written against two block-parallel hooks so the same driver
serves single-chip and distributed execution (``arslam.parallel``
supplies shard_map-wrapped hooks whose reductions psum over the block
shards):

  lin_fn(camera, cap_poses, tag_poses) -> (NormalEqs, cost)
  quality_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag)
      -> (new_cost, g_dot_d, jd_sq)

Memory note (the 40k-tag HBM fix): the loop state carries ONLY the
assembled normal equations — never the per-block Jacobian table.  The
step-quality quantities that used to need it (g_dot_d = d^T J^T r,
jd_sq = d^T J^T J d) come straight from the assembled blocks
(schur.quad_form_*), so rejected iterations cost one residual pass plus an
O(params) quad form, and the while_loop's biggest buffers shrink from
eqs + (B, 8, 15) Jacobians (doubled again at the accept-select) to eqs
alone.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from arslam.solve.residuals import linearize, residuals_and_rho
from arslam.solve.schur import (
    assemble,
    assemble_grouped,
    group_blocks_by_tag,
    group_blocks_by_tag_rows,
    quad_form_flat,
    quad_form_grouped,
    schur_solve,
    schur_solve_grouped,
    schur_solve_grouped_cg,
)


class LMConfig(NamedTuple):
    max_iterations: int = 50
    initial_lambda: float = 1e-4
    min_relative_decrease: float = 1e-3
    function_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-8
    # ceres Solver::Options::gradient_tolerance default (1e-10): terminate
    # when ||J^T r||_inf over active parameters falls at/below this
    # (ar_slam_util.cpp:1001-1018 runs ceres defaults, which include the
    # gradient-norm test)
    gradient_tolerance: float = 1e-10
    jacobi_scaling: bool = True
    max_lambda: float = 1e32
    min_lambda: float = 1e-16
    # terminate when damping grows past this (every step rejected — the
    # trust region has collapsed; ceres' "trust region radius too small")
    stall_lambda: float = 1e12
    # radial distortion model 1 + l1 r^2 + l2 r^4 (the reference carries
    # l1, l2 but leaves the model commented out, ar_slam_util.cpp:164-171);
    # off = parity (l1, l2 have zero gradient and stay fixed)
    enable_distortion: bool = False
    # reduced-system solver: "dense" = Cholesky on the (3+6C) system
    # (≙ DENSE_SCHUR); "cg" = implicit-Schur preconditioned CG
    # (≙ ITERATIVE_SCHUR; wins at large capture counts).  grouped path only.
    linear_solver: str = "dense"
    # loose relative tolerance + a step cap: the LM trust region absorbs
    # inexact steps (ceres ships ITERATIVE_SCHUR the same way), and the
    # measured sweet spot on the 10k-tag benchmark is 0.3 — 1.6x the
    # iteration rate of 1e-2 at matching final cost (0.5 is cruder:
    # rejected steps erase the matvec savings; 0.1 never fires inside the
    # cap).  Tighten for parity experiments via SolverConfig.cg_tolerance.
    cg_tolerance: float = 0.3
    cg_max_iterations: int = 25
    # robust loss: "trivial" ≙ the reference's nullptr loss
    # (ar_slam_util.cpp:832-836); "huber" IRLS-reweights blocks with
    # per-block cost rho (loss_scale = Huber delta in pixels)
    loss: str = "trivial"
    loss_scale: float = 4.0


class LMState(NamedTuple):
    camera: jnp.ndarray  # (3,)
    cap_poses: jnp.ndarray  # (C, 6)
    tag_poses: jnp.ndarray  # (T, 6)
    lam: jnp.ndarray  # ()
    nu: jnp.ndarray  # ()
    cost: jnp.ndarray  # ()
    iteration: jnp.ndarray  # () int
    converged: jnp.ndarray  # () bool
    term: jnp.ndarray  # () int32 termination code (TERMINATION_REASONS)


# per-solve termination reason (info["termination"]), mirroring ceres'
# TerminationType for the tests the reference's defaults enable
TERMINATION_REASONS = {
    0: "NO_CONVERGENCE",          # iteration budget exhausted
    1: "FUNCTION_TOLERANCE",
    2: "PARAMETER_TOLERANCE",
    3: "GRADIENT_TOLERANCE",
    4: "TRUST_REGION_STALL",      # every step rejected, lambda blew up
    5: "DISABLED",                # enabled=False seed-only call
}


def _grad_inf_norm(eqs, cam_active, cap_active, tag_active):
    """||J^T r||_inf over ACTIVE parameters (ceres' gradient test norm).

    Accepts either the field-named eqs tuples (NormalEqs / GroupedEqs) or
    the distributed hooks' ``(CapEqs, (hct, wt_s, htt, g_t))`` pair."""
    if hasattr(eqs, "g_t"):
        g_c, g_p, g_t = eqs.g_c, eqs.g_p, eqs.g_t
    else:
        cap_eqs, tag_side = eqs
        g_c, g_p, g_t = cap_eqs.g_c, cap_eqs.g_p, tag_side[-1]
    dt = g_p.dtype
    gc = jnp.where(jnp.asarray(cam_active), jnp.max(jnp.abs(g_c)),
                   jnp.asarray(0.0, dt))
    gp = jnp.max(jnp.abs(g_p) * cap_active[:, None].astype(dt))
    gt = jnp.max(jnp.abs(g_t) * tag_active[:, None].astype(dt))
    return jnp.maximum(gc, jnp.maximum(gp, gt))


def make_block_hooks(cap_idx, tag_idx, corners, block_mask, aruco_size,
                     n_caps, n_tags, distortion=False, loss="trivial",
                     loss_scale=1.0):
    """Single-device block-parallel hooks over a padded block table."""

    def lin_fn(camera, cap_poses, tag_poses):
        r, jc, jp, jt, rho = linearize(
            camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
            block_mask, aruco_size, distortion, loss, loss_scale,
        )
        eqs = assemble(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags)
        cost = 0.5 * jnp.sum(rho)
        return eqs, cost

    def quality_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag):
        _, rho_new = residuals_and_rho(
            new_camera, new_caps, new_tags, cap_idx, tag_idx, corners,
            block_mask, aruco_size, distortion, loss, loss_scale,
        )
        new_cost = 0.5 * jnp.sum(rho_new)
        g_dot_d, jd_sq = quad_form_flat(eqs, d_cam, d_cap, d_tag)
        return new_cost, g_dot_d, jd_sq

    return lin_fn, quality_fn


def make_grouped_hooks(cap_idx, tag_idx, corners, block_mask, aruco_size,
                       n_caps, n_tags, s_max, sc_max, distortion=False,
                       loss="trivial", loss_scale=1.0, row_slots=None,
                       n_rows=None, n_cap_rows=None):
    """Block-parallel hooks over a TAG-GROUPED (T*S) block table.

    The flat table regroups ONCE (one sort + small scatters, outside the LM
    loop) — by tag for the primary layout AND by capture (``sc_max`` slots
    per capture) for the capture-side reductions; every relinearization then
    assembles scatter-free via reshape-sums on both sides, with the cap/tag
    coupling kept capture-sparse as (T, S, 6, 6) blocks (round 1's dense
    (T, 3+6C, 6) slab and (T*S, C) one-hot routing are gone — both were
    memory walls at 10k tags / 4k captures).  Padding cost: T*S vs B rows
    (25% on the 500-tag benchmark).

    ``row_slots``/``n_rows`` (both static) switch the tag side to the
    ROW-SPLIT layout (schur.TagRows): slots pack into ``n_rows`` rows of
    ``row_slots`` each, a tag spanning ceil(obs/row_slots) consecutive
    rows — ~1.1-1.25x padding instead of the (T, S_max) rectangle's
    mean/max ratio (1.87x on the 10k-tag benchmark, multiplying every
    relinearization, assembly and CG matvec).  CG-solver only: the dense
    grouped elimination consumes the (T, S_max) form.

    Returns (lin_fn, quality_fn, group_ctx) where group_ctx =
    (cap_idx_g, cap_gather, cap_gmask, rows) feeds the solve functions.
    """
    if row_slots is not None:
        max_rows = -(-s_max // row_slots)
        gather, mask_g, rows = group_blocks_by_tag_rows(
            tag_idx, block_mask, n_tags, row_slots, n_rows, max_rows)
        s_used, lead = row_slots, n_rows
        tag_idx_g = jnp.repeat(rows.row_tag, row_slots,
                               total_repeat_length=n_rows * row_slots)
    else:
        gather, mask_g = group_blocks_by_tag(tag_idx, block_mask, n_tags,
                                             s_max)
        rows = None
        s_used, lead = s_max, n_tags
        tag_idx_g = jnp.repeat(
            jnp.arange(n_tags, dtype=jnp.int32), s_max,
            total_repeat_length=n_tags * s_max
        )
    cap_idx_g = cap_idx[gather]
    if row_slots is not None and n_cap_rows is not None:
        max_cap_rows = -(-sc_max // row_slots)
        cap_gather, cap_gmask, cap_rows = group_blocks_by_tag_rows(
            cap_idx_g, mask_g, n_caps, row_slots, n_cap_rows, max_cap_rows)
    else:
        cap_gather, cap_gmask = group_blocks_by_tag(cap_idx_g, mask_g,
                                                    n_caps, sc_max)
        cap_rows = None
    corners_g = corners[gather]

    def lin_fn(camera, cap_poses, tag_poses):
        r, jc, jp, jt, rho = linearize(
            camera, cap_poses, tag_poses, cap_idx_g, tag_idx_g, corners_g,
            mask_g, aruco_size, distortion, loss, loss_scale,
        )
        eqs = assemble_grouped(r, jc, jp, jt, cap_gather, cap_gmask, n_caps,
                               n_tags, s_used, rows=rows, cap_rows=cap_rows)
        cost = 0.5 * jnp.sum(rho)
        return eqs, cost

    def quality_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag):
        _, rho_new = residuals_and_rho(
            new_camera, new_caps, new_tags, cap_idx_g, tag_idx_g, corners_g,
            mask_g, aruco_size, distortion, loss, loss_scale,
        )
        new_cost = 0.5 * jnp.sum(rho_new)
        g_dot_d, jd_sq = quad_form_grouped(eqs, cap_idx_g, d_cam, d_cap,
                                           d_tag, rows=rows)
        return new_cost, g_dot_d, jd_sq

    return lin_fn, quality_fn, (cap_idx_g, cap_gather, cap_gmask, rows,
                                cap_rows)


def lm_core(camera, cap_poses, tag_poses, cam_active, cap_active, tag_active,
            lin_fn, quality_fn, config: LMConfig, enabled=True,
            solve_fn=None, iter_budget=None, solver_state0=None,
            quality_lin_fn=None, lam0=None, nu0=None):
    """Generic LM loop over block-parallel hooks.  Runs inside jit.

    The ASSEMBLED normal equations are carried in the loop state and
    recomputed ONLY when a step is accepted — rejected iterations re-solve
    the damped system with a new lambda plus one residual evaluation
    (standard LM engineering; ceres does the same via its
    evaluated-jacobian cache).  The per-block Jacobian table is NEVER
    carried: step quality needs only d^T g and d^T H d, which
    schur.quad_form_* reads off the assembled blocks — at 40k tags /
    1.05M observations a carried Jacobian table (plus its speculative
    twin at the accept-select) would be gigabytes of device memory.

    ``enabled`` may be a traced bool: when False the while_loop runs zero
    iterations (state starts converged), so the SAME compiled program serves
    seed-only waves (solver_config.optimize_every) without a recompile.

    ``solve_fn(eqs, lam) -> (d_cam, d_cap, d_tag)`` overrides the damped
    Schur solve (the distributed solver supplies a tag-sharded version);
    default = single-device ``schur_solve``.  With ``solver_state0`` set,
    the convention becomes ``solve_fn(eqs, lam, state) -> (d_cam, d_cap,
    d_tag, state)`` — the state threads through the loop (the CG path
    warm-starts from the previous reduced solution).

    ``iter_budget`` (traced int, optional) caps iterations below
    config.max_iterations WITHOUT recompiling — one compiled program
    serves any budget (benchmarks time two budgets and subtract).

    ``quality_lin_fn(eqs, new_camera, new_caps, new_tags, d_cam, d_cap,
    d_tag) -> (new_cost, g_dot_d, jd_sq, eqs_new)`` optionally FUSES
    step-quality evaluation with a SPECULATIVE relinearization at the
    proposed parameters, replacing quality_fn + the accept-path lin_fn.
    The distributed hooks supply one whose reductions share a single packed
    psum — cutting per-iteration collectives from 3 to 2 (latency-bound
    multi-controller links care about collective COUNT, and the extra
    Jacobian work on rejected steps is idle compute there).  On accept the
    speculative eqs are exactly what the next iteration needs; on reject
    they are discarded by a where-select.
    """
    dtype = cap_poses.dtype
    stateful = solver_state0 is not None
    sol0 = solver_state0 if stateful else jnp.zeros((), dtype)
    if solve_fn is None:
        def solve_fn(eqs, lam):
            return schur_solve(
                eqs, lam, cam_active, cap_active, tag_active,
                jacobi_scaling=config.jacobi_scaling,
            )

    eqs0, cost0 = lin_fn(camera, cap_poses, tag_poses)
    # ceres checks the gradient test at iteration 0 too (a problem started
    # at its optimum terminates GRADIENT_TOLERANCE without stepping)
    g_conv0 = _grad_inf_norm(eqs0, cam_active, cap_active, tag_active) <= (
        config.gradient_tolerance)
    enabled_t = jnp.asarray(enabled)
    state0 = LMState(
        camera=camera.astype(dtype),
        cap_poses=cap_poses,
        tag_poses=tag_poses,
        # lam0/nu0 (traced, optional) resume the damping schedule across
        # host-stepped calls (minimizer_progress_to_stdout)
        lam=(jnp.asarray(config.initial_lambda, dtype) if lam0 is None
             else jnp.asarray(lam0, dtype)),
        nu=(jnp.asarray(2.0, dtype) if nu0 is None
            else jnp.asarray(nu0, dtype)),
        cost=cost0,
        iteration=jnp.asarray(0, jnp.int32),
        converged=jnp.logical_not(enabled_t) | g_conv0,
        term=jnp.where(enabled_t,
                       jnp.where(g_conv0, jnp.int32(3), jnp.int32(0)),
                       jnp.int32(5)),
    )

    def body(carry):
        state, eqs, sol = carry
        if stateful:
            d_cam, d_cap, d_tag, sol = solve_fn(eqs, state.lam, sol)
        else:
            d_cam, d_cap, d_tag = solve_fn(eqs, state.lam)

        new_camera = state.camera + d_cam
        new_caps = state.cap_poses + d_cap
        new_tags = state.tag_poses + d_tag
        if quality_lin_fn is not None:
            new_cost, g_dot_d, jd_sq, eqs_prop = quality_lin_fn(
                eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag
            )
        else:
            new_cost, g_dot_d, jd_sq = quality_fn(
                eqs, new_camera, new_caps, new_tags, d_cam, d_cap, d_tag
            )

        model_decrease = jnp.maximum(-g_dot_d - 0.5 * jd_sq, 1e-30)
        rho = (state.cost - new_cost) / model_decrease
        accept = rho > config.min_relative_decrease

        lam_acc = state.lam * jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
        )
        lam_acc = jnp.clip(lam_acc, config.min_lambda, config.max_lambda)
        lam_rej = jnp.minimum(state.lam * state.nu, config.max_lambda)

        cost_change = jnp.abs(state.cost - new_cost)
        f_conv = cost_change <= config.function_tolerance * state.cost
        step_norm = jnp.sqrt(
            jnp.sum(d_cam**2) + jnp.sum(d_cap**2) + jnp.sum(d_tag**2)
        )
        x_norm = jnp.sqrt(
            jnp.sum(state.camera**2)
            + jnp.sum(state.cap_poses**2)
            + jnp.sum(state.tag_poses**2)
        )
        p_conv = step_norm <= config.parameter_tolerance * (
            x_norm + config.parameter_tolerance
        )
        stalled = ~accept & (state.lam >= config.stall_lambda)
        converged_fp = (accept & (f_conv | p_conv)) | stalled

        if quality_lin_fn is not None:
            # speculative relinearization already happened at the proposed
            # params (fused with quality's psum) — select, don't recompute
            def sel(a, b):
                return jnp.where(accept, a, b)

            eqs_n = jax.tree_util.tree_map(sel, eqs_prop, eqs)
        else:
            # relinearize only on accepted (and not-yet-converged) steps
            def do_lin(_):
                eqs2, _ = lin_fn(new_camera, new_caps, new_tags)
                return eqs2

            def keep(_):
                return eqs

            eqs_n = jax.lax.cond(accept & ~converged_fp, do_lin, keep, None)

        # ceres' gradient test on the fresh linearization.  Only meaningful
        # when eqs_n is fresh, i.e. accepted and not already f/p-converged
        # (when f/p fired the stale-eqs case doesn't matter — we stop with
        # that reason anyway).
        g_conv = accept & ~converged_fp & (
            _grad_inf_norm(eqs_n, cam_active, cap_active, tag_active)
            <= config.gradient_tolerance)
        converged = converged_fp | g_conv
        term = jnp.where(
            stalled, jnp.int32(4),
            jnp.where(g_conv, jnp.int32(3),
                      jnp.where(accept & f_conv, jnp.int32(1),
                                jnp.where(accept & p_conv, jnp.int32(2),
                                          jnp.int32(0)))))

        new_state = LMState(
            camera=jnp.where(accept, new_camera, state.camera),
            cap_poses=jnp.where(accept, new_caps, state.cap_poses),
            tag_poses=jnp.where(accept, new_tags, state.tag_poses),
            lam=jnp.where(accept, lam_acc, lam_rej),
            nu=jnp.where(accept, jnp.asarray(2.0, dtype), state.nu * 2.0),
            cost=jnp.where(accept, new_cost, state.cost),
            iteration=state.iteration + 1,
            converged=converged,
            term=term,
        )
        if stateful:
            # warm start helps only the rejected-step re-solve (same
            # linearization, larger damping -> shrunk but aligned step);
            # after an accept the next optimal step is near zero
            sol = jax.tree_util.tree_map(
                lambda s: jnp.where(accept, jnp.zeros_like(s), s), sol)
        return new_state, eqs_n, sol

    budget = jnp.asarray(
        config.max_iterations if iter_budget is None else iter_budget,
        jnp.int32,
    )
    budget = jnp.minimum(budget, config.max_iterations)

    def cond(carry):
        state = carry[0]
        return (state.iteration < budget) & ~state.converged

    final, eqs_f, _ = jax.lax.while_loop(cond, body, (state0, eqs0, sol0))
    info = {
        "cost": final.cost,
        "iterations": final.iteration,
        "lambda": final.lam,
        "converged": final.converged,
        "initial_cost": state0.cost,
        "termination": final.term,
        "nu": final.nu,
        "grad_max": _grad_inf_norm(eqs_f, cam_active, cap_active,
                                   tag_active),
    }
    return final.camera, final.cap_poses, final.tag_poses, info


@partial(jax.jit, static_argnames=("aruco_size", "config", "assemble_fn",
                                   "obs_per_tag", "obs_per_cap",
                                   "row_slots", "tag_rows", "cap_rows"))
def lm_solve(
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
    assemble_fn=None,
    enabled=True,
    iter_budget=None,
    obs_per_tag: int | None = None,
    obs_per_cap: int | None = None,
    row_slots: int | None = None,
    tag_rows: int | None = None,
    cap_rows: int | None = None,
    lam0=None,
    nu0=None,
):
    """Run LM to convergence on the (masked, padded) problem.

    ``obs_per_tag``: static max observations per tag; when set, the solver
    runs the TAG-GROUPED scatter-free assembly (see make_grouped_hooks) —
    the production path.  Callers must pass a true upper bound (excess
    observations of a tag would be silently dropped).  ``obs_per_cap`` is
    the matching static max observations per CAPTURE for the
    capture-grouped reductions (defaults to n_tags * obs_per_tag — always
    safe but wasteful; pass the bucketed true bound).

    ``assemble_fn`` optionally overrides normal-equation assembly (the
    distributed solver passes a psum-reducing version; see
    arslam.parallel.dist_lm which instead wraps the full hooks).

    ``row_slots``/``tag_rows`` (static; CG solver only) switch the grouped
    layout to ROW-SPLIT packing: tag_rows rows of row_slots slots, a tag
    spanning ceil(obs/row_slots) consecutive rows — cuts the (T, S_max)
    rectangle's padding (see make_grouped_hooks).  Callers must size
    tag_rows ≥ Σ_t ceil(obs_t / row_slots); ignored for the dense solver.
    """
    n_caps = cap_poses.shape[0]
    n_tags = tag_poses.shape[0]
    if obs_per_tag is not None and assemble_fn is None:
        if obs_per_cap is None:
            obs_per_cap = n_tags * obs_per_tag
        if config.linear_solver != "cg":
            # the dense grouped elimination consumes the (T, S_max) form
            row_slots = tag_rows = cap_rows = None
        lin_fn, quality_fn, group_ctx = make_grouped_hooks(
            cap_idx, tag_idx, corners, block_mask, aruco_size, n_caps,
            n_tags, obs_per_tag, obs_per_cap,
            distortion=config.enable_distortion,
            loss=config.loss, loss_scale=config.loss_scale,
            row_slots=row_slots, n_rows=tag_rows, n_cap_rows=cap_rows,
        )
        cap_idx_g, cap_gather, cap_gmask, rows, cap_rows_ctx = group_ctx

        solver_state0 = None
        if config.linear_solver == "cg":
            # warm-start each CG from the previous reduced solution
            solver_state0 = jnp.zeros(3 + 6 * n_caps, cap_poses.dtype)

            def solve_fn(eqs, lam, x0):
                return schur_solve_grouped_cg(
                    eqs, cap_idx_g, cap_gather, cap_gmask, lam,
                    cam_active, cap_active, tag_active,
                    jacobi_scaling=config.jacobi_scaling,
                    cg_tol=config.cg_tolerance,
                    cg_iters=config.cg_max_iterations,
                    x0=x0, rows=rows, cap_rows=cap_rows_ctx,
                )
        else:
            def solve_fn(eqs, lam):
                return schur_solve_grouped(
                    eqs, cap_idx_g, lam, cam_active, cap_active, tag_active,
                    jacobi_scaling=config.jacobi_scaling,
                )

        return lm_core(camera, cap_poses, tag_poses, cam_active, cap_active,
                       tag_active, lin_fn, quality_fn, config,
                       enabled=enabled, solve_fn=solve_fn,
                       iter_budget=iter_budget, solver_state0=solver_state0,
                       lam0=lam0, nu0=nu0)
    lin_fn, quality_fn = make_block_hooks(
        cap_idx, tag_idx, corners, block_mask, aruco_size, n_caps, n_tags,
        distortion=config.enable_distortion, loss=config.loss,
        loss_scale=config.loss_scale,
    )
    if assemble_fn is not None:
        # custom assembly must still produce NormalEqs-shaped blocks (the
        # quality quad form reads them)
        def lin_fn(camera, cap_poses, tag_poses):  # noqa: F811
            r, jc, jp, jt, rho = linearize(
                camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
                block_mask, aruco_size, config.enable_distortion,
                config.loss, config.loss_scale,
            )
            eqs = assemble_fn(r, jc, jp, jt, cap_idx, tag_idx, n_caps, n_tags)
            return eqs, 0.5 * jnp.sum(rho)

    return lm_core(camera, cap_poses, tag_poses, cam_active, cap_active,
                   tag_active, lin_fn, quality_fn, config, enabled=enabled,
                   iter_budget=iter_budget, lam0=lam0, nu0=nu0)
