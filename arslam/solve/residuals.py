"""Batched linearization of the reprojection problem.

Per block (one tag observed in one capture) the residual is 8 values and the
Jacobian splits into three parameter blocks — camera (3), capture inverse
pose (6), tag pose (6) — mirroring the reference's
``AutoDiffCostFunction<ArucoReprojectionError, 8, 3, 6, 6>``
(ar_slam_util.cpp:826-836).  Derivatives come from ``jax.jacfwd`` vmapped
over the padded block table; XLA fuses the 15 forward tangents into one
batched computation, the device analogue of ceres Jet autodiff.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arslam.core.projection import block_residual


def _one_block(camera, cap_pose, tag_pose, corners, aruco_size,
               distortion=False):
    return block_residual(camera, cap_pose, tag_pose, corners, aruco_size,
                          distortion)


def robust_weights(r, loss: str = "trivial", scale: float = 1.0):
    """Per-block IRLS weight and robust cost from raw (B, 8) residuals.

    ``loss='huber'``: rho(s) = s for s <= delta^2, 2*delta*sqrt(s) - delta^2
    beyond (ceres HuberLoss with a = scale, in pixels); the weight is
    sqrt(rho'(s)).  ``'trivial'`` ≙ the reference's nullptr loss
    (ar_slam_util.cpp:832-836).

    Returns (w (B,), rho (B,)) with rho the per-block robust cost term.
    """
    s = jnp.sum(r * r, axis=1)
    if loss == "trivial":
        return jnp.ones_like(s), s
    if loss != "huber":
        raise ValueError(f"unknown loss {loss!r}")
    d2 = scale * scale
    root = jnp.sqrt(jnp.maximum(s, 1e-30))
    rho = jnp.where(s <= d2, s, 2.0 * scale * root - d2)
    w = jnp.where(s <= d2, 1.0, jnp.sqrt(scale / root))
    return w, rho


def linearize(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
              block_mask, aruco_size, distortion=False,
              loss: str = "trivial", loss_scale: float = 1.0):
    """Residuals + Jacobian blocks for every block in the padded table.

    With a robust ``loss``, residuals and Jacobian rows are IRLS-weighted
    (sqrt(rho')) so the normal equations realize the robustified
    Gauss-Newton system.

    Returns:
      r:  (B, 8)   (weighted) residuals (masked rows zero)
      jc: (B, 8, 3) d r / d camera
      jp: (B, 8, 6) d r / d capture inverse pose
      jt: (B, 8, 6) d r / d tag pose
      rho: (B,)    per-block robust cost (== |r|^2 for trivial loss)
    """

    def res(camera, cap_pose, tag_pose, corners):
        r = _one_block(camera, cap_pose, tag_pose, corners, aruco_size,
                       distortion)
        return r, r  # aux carries the primal out of jacfwd for free

    def res_and_jac(cap_i, tag_i, crn):
        cap_pose = cap_poses[cap_i]
        tag_pose = tag_poses[tag_i]
        (jc, jp, jt), r = jax.jacfwd(res, argnums=(0, 1, 2), has_aux=True)(
            camera, cap_pose, tag_pose, crn
        )
        return r, jc, jp, jt

    r, jc, jp, jt = jax.vmap(res_and_jac)(cap_idx, tag_idx, corners)
    # where-based masking (not multiply): inactive rows may hold inf/NaN
    # garbage and inf * 0 = NaN would poison the normal equations.
    m = block_mask[:, None]
    r = jnp.where(m, r, 0.0)
    jc = jnp.where(m[:, :, None], jc, 0.0)
    jp = jnp.where(m[:, :, None], jp, 0.0)
    jt = jnp.where(m[:, :, None], jt, 0.0)
    w, rho = robust_weights(r, loss, loss_scale)
    rho = jnp.where(block_mask, rho, 0.0)
    if loss != "trivial":
        r = r * w[:, None]
        jc = jc * w[:, None, None]
        jp = jp * w[:, None, None]
        jt = jt * w[:, None, None]
    return r, jc, jp, jt, rho


def residuals_only(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
                   block_mask, aruco_size, distortion=False):
    """(B, 8) masked raw residuals without Jacobians."""

    def res(cap_i, tag_i, crn):
        return _one_block(camera, cap_poses[cap_i], tag_poses[tag_i], crn,
                          aruco_size, distortion)

    r = jax.vmap(res)(cap_idx, tag_idx, corners)
    return jnp.where(block_mask[:, None], r, 0.0)


def residuals_and_rho(camera, cap_poses, tag_poses, cap_idx, tag_idx,
                      corners, block_mask, aruco_size, distortion=False,
                      loss: str = "trivial", loss_scale: float = 1.0):
    """(weighted residuals (B, 8), per-block robust cost (B,))."""
    r = residuals_only(camera, cap_poses, tag_poses, cap_idx, tag_idx,
                       corners, block_mask, aruco_size, distortion)
    w, rho = robust_weights(r, loss, loss_scale)
    rho = jnp.where(block_mask, rho, 0.0)
    if loss != "trivial":
        r = r * w[:, None]
    return r, rho


def total_cost(camera, cap_poses, tag_poses, cap_idx, tag_idx, corners,
               block_mask, aruco_size, distortion=False,
               loss: str = "trivial", loss_scale: float = 1.0):
    """0.5 * sum of (robust) block costs (ceres cost convention)."""
    _, rho = residuals_and_rho(camera, cap_poses, tag_poses, cap_idx,
                               tag_idx, corners, block_mask, aruco_size,
                               distortion, loss, loss_scale)
    return 0.5 * jnp.sum(rho)
