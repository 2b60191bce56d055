"""Pose seeding (pure jnp, batchable).

Two seeding families:

1. The reference's frontal heuristics (calcInitValues / initCapturePose /
   initArPose, ar_slam_util.cpp:52-128): depth from the longest rect edge
   ``z = focal * aruco_size / max_edge`` (:83), x,y from corner-centroid
   back-projection (:84-85), in-plane rotation from a running average of
   per-corner angle deltas vs ARUCO_DIRECTIONS (:72-80).  Out-of-plane
   rotation is NOT estimated (TODO at :70) — which strands tilted tags in
   the flipped basin of the planar-pose ambiguity.

2. Homography (Zhang-style) planar pose: the exact tag→image DLT homography
   decomposed with K = diag(f, f, 1) gives the full 6-DoF tag pose in the
   camera frame, including out-of-plane tilt.

``seed_tag_pose`` / ``seed_capture_pose`` evaluate both candidates and keep
the one with lower reprojection residual — strictly better initialization
than the reference at negligible cost (config
``SolverConfig.seed_mode = "hybrid" | "frontal"``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arslam.core.lie import (
    axis_angle_rotate,
    compose_axis_angle,
    matrix_to_axis_angle,
    normalize_angle,
)
from arslam.core.projection import ARUCO_DIRECTIONS


def calc_init_values(corners, focal, aruco_size):
    """Estimate (local_x, local_y, local_z, rot_z) of a tag in the camera
    frame from its detected rect.

    Args:
      corners: (4, 2) detected corners, centered pixel coords.
      focal: scalar focal length.
      aruco_size: scalar tag edge length (meters).

    Returns:
      (4,) array [local_x, local_y, local_z, rot_z].
    """
    corners = jnp.asarray(corners)
    nxt = jnp.roll(corners, shift=-1, axis=0)  # corner (idx+1) & 3
    edge_sq = jnp.sum((corners - nxt) ** 2, axis=-1)
    max_edge = jnp.sqrt(jnp.max(edge_sq))
    center = jnp.mean(corners, axis=0)

    directions = ARUCO_DIRECTIONS.astype(corners.dtype)
    expected = jnp.arctan2(directions[:, 1], directions[:, 0])
    actual = jnp.arctan2(corners[:, 1] - center[1], corners[:, 0] - center[0])
    delta = normalize_angle(actual - expected)

    # Sequential running average (avg += normalize(delta - avg)/(i+1)) —
    # order-dependent through the normalize, so replicated exactly.
    avg = delta[0]
    for idx in range(1, 4):
        avg = avg + normalize_angle(delta[idx] - avg) / (idx + 1)

    local_z = focal * aruco_size / max_edge
    local_x = center[0] * local_z / focal
    local_y = center[1] * local_z / focal
    return jnp.stack([local_x, local_y, local_z, avg])


def init_capture_pose(corners, camera, ar_pose, aruco_size):
    """Seed a capture's INVERSE pose from one observed tag with known pose
    (≙ initCapturePose, ar_slam_util.cpp:91-108).

    Returns: (6,) inverse capture pose.
    """
    camera = jnp.asarray(camera)
    ar_pose = jnp.asarray(ar_pose)
    vals = calc_init_values(corners, camera[0], aruco_size)
    local_position = vals[0:3]
    local_rot = jnp.stack([jnp.zeros_like(vals[3]), jnp.zeros_like(vals[3]), vals[3]])
    inv_rot = compose_axis_angle(local_rot, -ar_pose[3:6])
    cap_rotation = -inv_rot
    inv_t = axis_angle_rotate(cap_rotation, local_position) - ar_pose[0:3]
    return jnp.concatenate([inv_t, inv_rot])


def init_ar_pose(corners, camera, inv_cap_pose, aruco_size):
    """Seed a tag's pose from one observing capture with known pose
    (≙ initArPose, ar_slam_util.cpp:111-128).

    Returns: (6,) tag pose.
    """
    camera = jnp.asarray(camera)
    inv_cap_pose = jnp.asarray(inv_cap_pose)
    vals = calc_init_values(corners, camera[0], aruco_size)
    local_position = vals[0:3]
    cap_rotation = -inv_cap_pose[3:6]
    ar_t = axis_angle_rotate(cap_rotation, local_position) - inv_cap_pose[0:3]
    local_rot = jnp.stack([jnp.zeros_like(vals[3]), jnp.zeros_like(vals[3]), vals[3]])
    ar_rot = compose_axis_angle(cap_rotation, local_rot)
    return jnp.concatenate([ar_t, ar_rot])


# ---------------------------------------------------------------------------
# Homography-based planar pose (Zhang) — full 6-DoF tag-in-camera estimate
# ---------------------------------------------------------------------------


def homography_from_corners(corners, aruco_size):
    """Exact DLT homography mapping tag-plane corners to observed (centered)
    image corners.  (3, 3), with H[2,2] normalized to 1 by construction.

    Solves the 8x8 linear system directly (4 exact correspondences).
    """
    corners = jnp.asarray(corners)
    dtype = corners.dtype
    src = ARUCO_DIRECTIONS.astype(dtype) * (0.5 * aruco_size)  # (4,2)

    def rows(i):
        x, y = src[i, 0], src[i, 1]
        u, v = corners[i, 0], corners[i, 1]
        one = jnp.ones((), dtype)
        zero = jnp.zeros((), dtype)
        r1 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y])
        r2 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y])
        return jnp.stack([r1, r2]), jnp.stack([u, v])

    ab = [rows(i) for i in range(4)]
    a = jnp.concatenate([x[0] for x in ab], axis=0)  # (8, 8)
    b = jnp.concatenate([x[1] for x in ab], axis=0)  # (8,)
    h8 = jnp.linalg.solve(a, b)
    h = jnp.concatenate([h8, jnp.ones((1,), dtype)]).reshape(3, 3)
    return h


def tag_pose_in_camera_homography(corners, focal, aruco_size):
    """Full 6-DoF tag pose in the camera frame from the tag homography.

    Returns (rot_aa (3,), t (3,)): p_cam = R(rot) p_tag + t.
    """
    h = homography_from_corners(corners, aruco_size)
    focal = jnp.asarray(focal)
    # M = K^{-1} H  with K = diag(f, f, 1), principal point at center
    m = jnp.stack([h[0] / focal, h[1] / focal, h[2]], axis=0)
    m1, m2, m3 = m[:, 0], m[:, 1], m[:, 2]
    lam = 2.0 / (jnp.linalg.norm(m1) + jnp.linalg.norm(m2) + 1e-30)
    # resolve the projective sign so the tag sits in front of the camera
    sign = jnp.where(m3[2] * lam > 0, 1.0, -1.0).astype(m.dtype)
    m1, m2, m3 = sign * m1, sign * m2, sign * m3
    t = lam * m3
    r1 = m1 / (jnp.linalg.norm(m1) + 1e-30)
    r2 = m2 - r1 * jnp.dot(r1, m2)
    r2 = r2 / (jnp.linalg.norm(r2) + 1e-30)
    r3 = jnp.cross(r1, r2)
    rot = jnp.stack([r1, r2, r3], axis=1)  # columns
    return matrix_to_axis_angle(rot), t


def init_ar_pose_homography(corners, camera, inv_cap_pose, aruco_size):
    """Tag world pose from homography decomposition through a known capture.

    p_world = R(-inv_rot)(R_cam p_tag + t_cam) - inv_t
    """
    camera = jnp.asarray(camera)
    inv_cap_pose = jnp.asarray(inv_cap_pose)
    rot_cam, t_cam = tag_pose_in_camera_homography(
        corners, camera[0], aruco_size
    )
    cap_rotation = -inv_cap_pose[3:6]
    ar_t = axis_angle_rotate(cap_rotation, t_cam) - inv_cap_pose[0:3]
    ar_rot = compose_axis_angle(cap_rotation, rot_cam)
    return jnp.concatenate([ar_t, ar_rot])


def init_capture_pose_homography(corners, camera, ar_pose, aruco_size):
    """Capture INVERSE pose from homography decomposition of a known tag.

    R_inv = R_cam R_wt^T ;  t_inv = R(-inv_rot) t_cam - ar_t
    """
    camera = jnp.asarray(camera)
    ar_pose = jnp.asarray(ar_pose)
    rot_cam, t_cam = tag_pose_in_camera_homography(
        corners, camera[0], aruco_size
    )
    inv_rot = compose_axis_angle(rot_cam, -ar_pose[3:6])
    inv_t = axis_angle_rotate(-inv_rot, t_cam) - ar_pose[0:3]
    return jnp.concatenate([inv_t, inv_rot])


# ---------------------------------------------------------------------------
# Candidate-selection seeding (frontal vs homography, pick lower residual)
# ---------------------------------------------------------------------------


def _rect_cost(camera, inv_cap_pose, tag_pose, corners, aruco_size):
    from arslam.core.projection import block_residual

    r = block_residual(camera, inv_cap_pose, tag_pose, corners, aruco_size)
    c = jnp.sum(r * r)
    return jnp.where(jnp.isfinite(c), c, jnp.inf)


def seed_tag_pose(corners, camera, inv_cap_pose, aruco_size,
                  mode: str = "hybrid"):
    """Seed a tag's world pose from one observing capture."""
    frontal = init_ar_pose(corners, camera, inv_cap_pose, aruco_size)
    if mode == "frontal":
        return frontal
    homog = init_ar_pose_homography(corners, camera, inv_cap_pose, aruco_size)
    homog = jnp.where(jnp.isfinite(homog), homog, 0.0)
    c_f = _rect_cost(camera, inv_cap_pose, frontal, corners, aruco_size)
    c_h = _rect_cost(camera, inv_cap_pose, homog, corners, aruco_size)
    return jnp.where(c_h < c_f, homog, frontal)


def seed_capture_pose(corners, camera, ar_pose, aruco_size,
                      mode: str = "hybrid"):
    """Seed a capture's inverse pose from one observed known tag."""
    frontal = init_capture_pose(corners, camera, ar_pose, aruco_size)
    if mode == "frontal":
        return frontal
    homog = init_capture_pose_homography(corners, camera, ar_pose, aruco_size)
    homog = jnp.where(jnp.isfinite(homog), homog, 0.0)
    c_f = _rect_cost(camera, frontal, ar_pose, corners, aruco_size)
    c_h = _rect_cost(camera, homog, ar_pose, corners, aruco_size)
    return jnp.where(c_h < c_f, homog, frontal)


def seed_capture_pose_multi(anchor_corners, camera, anchor_tag_poses,
                            anchor_mask, aruco_size, mode: str = "hybrid"):
    """Seed a capture's inverse pose from ALL its observations of already-
    initialized tags (anchors).

    Per-anchor candidate poses come from ``seed_capture_pose``; their
    masked position mean + quaternion (chordal) rotation mean joins them as
    one more candidate, and the winner is the candidate with the lowest
    total reprojection cost over the anchors.  With ONE valid anchor this
    reduces exactly to ``seed_capture_pose`` — the reference's single
    init_block seed (ar_slam_util.cpp:803-807, :91-108).  Averaging over k
    anchors shrinks the per-hop seed error ~sqrt(k): the difference between
    chained BFS seeding drifting out of the convergence basin at 10k-tag
    scale and staying in it.

    Args:
      anchor_corners: (S, 4, 2) detected rects.
      anchor_tag_poses: (S, 6) world poses of the anchors' tags.
      anchor_mask: (S,) bool valid-anchor mask (at least one True when the
        result is used; the caller keeps the old pose otherwise).
    Returns: (6,) inverse capture pose.
    """
    import jax

    from arslam.core.lie import (axis_angle_to_quaternion,
                                      quaternion_to_axis_angle)

    cands = jax.vmap(
        lambda c, t: seed_capture_pose(c, camera, t, aruco_size, mode=mode)
    )(anchor_corners, anchor_tag_poses)  # (S, 6)
    m = anchor_mask.astype(cands.dtype)
    denom = jnp.maximum(m.sum(), 1.0)
    pos_mean = (cands[:, 0:3] * m[:, None]).sum(0) / denom
    q = jax.vmap(axis_angle_to_quaternion)(cands[:, 3:6])  # (S, 4)
    q0 = q[jnp.argmax(anchor_mask)]  # first valid anchor's quaternion
    sign = jnp.where(jnp.sum(q * q0, axis=-1, keepdims=True) < 0.0, -1.0, 1.0)
    qm = (q * sign * m[:, None]).sum(0)
    qm = qm / jnp.maximum(jnp.linalg.norm(qm), 1e-12)
    mean_pose = jnp.concatenate([pos_mean, quaternion_to_axis_angle(qm)])

    all_cands = jnp.concatenate([cands, mean_pose[None]], axis=0)  # (S+1, 6)

    def total_cost(pose):
        costs = jax.vmap(
            lambda c, t: _rect_cost(camera, pose, t, c, aruco_size)
        )(anchor_corners, anchor_tag_poses)
        return jnp.sum(jnp.where(anchor_mask, costs, 0.0))

    scores = jax.vmap(total_cost)(all_cands)  # (S+1,)
    scores = jnp.concatenate(
        [jnp.where(anchor_mask, scores[:-1], jnp.inf), scores[-1:]])
    best = all_cands[jnp.argmin(scores)]

    # pose-only Gauss-Newton refinement against the anchors (incremental-
    # SfM resectioning): a few guarded damped steps on the 6-dof capture
    # pose with the anchor tags held fixed.  The averaged/selected
    # candidate alone can be a poor compromise when the anchors' own seed
    # poses disagree; the refit is what actually minimizes the anchor
    # reprojection error.
    from arslam.solve.residuals import block_residual

    def anchor_residuals(pose):
        rs = jax.vmap(
            lambda c, t: block_residual(camera, pose, t, c, aruco_size)
        )(anchor_corners, anchor_tag_poses)  # (S, 8)
        rs = jnp.where(anchor_mask[:, None], rs, 0.0)
        rs = jnp.where(jnp.isfinite(rs), rs, 0.0)
        return rs.reshape(-1)

    def gn_step(pose, _):
        r = anchor_residuals(pose)
        jac = jax.jacfwd(anchor_residuals)(pose)  # (S*8, 6)
        hp = jax.lax.Precision.HIGHEST  # TF32 would round the normal eqs
        h = (jnp.matmul(jac.T, jac, precision=hp)
             + 1e-4 * jnp.eye(6, dtype=pose.dtype))
        step = jnp.linalg.solve(h, jnp.matmul(jac.T, r, precision=hp))
        new = pose - step
        new = jnp.where(jnp.isfinite(new), new, pose)
        better = total_cost(new) < total_cost(pose)
        return jnp.where(better, new, pose), None

    import jax.lax

    best, _ = jax.lax.scan(gn_step, best, None, length=3)

    # exactly one anchor: return its candidate verbatim (bit-identical to
    # seed_capture_pose, the reference's single init_block seed)
    first = cands[jnp.argmax(anchor_mask)]
    return jnp.where(m.sum() == 1.0, first, best)
