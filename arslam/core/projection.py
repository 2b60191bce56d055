"""Camera model and reprojection residuals (pure jnp).

Replicates the reference projection math exactly (projectCorner,
ar_slam_util.cpp:131-172) so that map.yaml artifacts are numerically
interchangeable:

- Tag corners live at ``(+-aruco_size/2, +-aruco_size/2, 0)`` in the tag
  frame; the tag's +z axis points out of the printed face
  (ar_slam_util.cpp:139).
- World point: ``p_w = R(tag_rot) c + tag_t``.
- Camera point uses the capture's stored INVERSE pose with
  translate-THEN-rotate order: ``p_c = R(inv_rot) (p_w + inv_t)``
  (ar_slam_util.cpp:150-155; convention note ar_slam_util.hpp:204-208).
- Pinhole: ``uv = focal * (x/z, y/z)`` in centered image coordinates
  (origin at image center, +y down — ar_slam_util.hpp:243-263).  Principal
  point is the image center; radial terms l1,l2 are carried but disabled,
  matching the commented-out distortion block (ar_slam_util.cpp:164-171).

Corner ordering is OpenCV aruco order top-left, top-right, bottom-right,
bottom-left with tag-frame directions (-1,-1),(+1,-1),(+1,+1),(-1,+1)
(ARUCO_DIRECTIONS, ar_slam_util.hpp:335-345).
"""

from __future__ import annotations

import jax.numpy as jnp

from arslam.core.lie import axis_angle_rotate

# Corner direction table, row idx = detection corner order.
ARUCO_DIRECTIONS = jnp.array(
    [
        [-1.0, -1.0],
        [+1.0, -1.0],
        [+1.0, +1.0],
        [-1.0, +1.0],
    ]
)


def tag_corners_local(aruco_size, dtype=jnp.float32):
    """(4, 3) tag-frame corner positions."""
    d = ARUCO_DIRECTIONS.astype(dtype)
    xy = 0.5 * aruco_size * d
    return jnp.concatenate([xy, jnp.zeros((4, 1), dtype)], axis=-1)


def project_corners(camera, inv_cap_pose, tag_pose, aruco_size,
                    distortion: bool = False):
    """Project all 4 corners of one tag into one capture.

    Args:
      camera: (3,) ``[focal, l1, l2]``.
      inv_cap_pose: (6,) inverse capture pose ``[t(3), axis-angle(3)]``.
      tag_pose: (6,) tag pose ``[t(3), axis-angle(3)]``.
      aruco_size: scalar tag edge length (meters).
      distortion: static switch for the radial model the reference carries
        but leaves commented out (ar_slam_util.cpp:164-171):
        ``uv = focal * (1 + l1 r^2 + l2 r^4) * (x/z, y/z)``.  Off (parity)
        by default — then l1, l2 have zero gradient and stay fixed.

    Returns:
      (4, 2) projected corner positions in centered pixel coordinates.
    """
    camera = jnp.asarray(camera)
    inv_cap_pose = jnp.asarray(inv_cap_pose)
    tag_pose = jnp.asarray(tag_pose)

    corners = tag_corners_local(aruco_size, dtype=tag_pose.dtype)  # (4,3)
    # tag frame -> world
    corners_w = (
        axis_angle_rotate(tag_pose[None, 3:6], corners) + tag_pose[None, 0:3]
    )
    # world -> camera: translate by inverse translation, then rotate
    corners_c = axis_angle_rotate(
        inv_cap_pose[None, 3:6], corners_w + inv_cap_pose[None, 0:3]
    )
    focal = camera[0]
    # Sign-preserving depth clamp: padded/garbage problem rows can place a
    # corner exactly at z=0; keep the math finite so masked lanes cannot
    # poison reductions with inf/NaN (the LM mask zeroes them afterwards).
    z = corners_c[:, 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, jnp.where(z < 0, -1e-9, 1e-9), z)
    xy = corners_c[:, 0:2] / z_safe
    if distortion:
        r2 = jnp.sum(xy * xy, axis=-1, keepdims=True)
        xy = xy * (1.0 + r2 * (camera[1] + camera[2] * r2))
    return focal * xy


def block_residual(camera, inv_cap_pose, tag_pose, observed, aruco_size,
                   distortion: bool = False):
    """8-vector reprojection residual for one block (one tag in one capture):
    projected − observed, interleaved (x0, y0, x1, y1, ...) like the
    reference ArucoReprojectionError (ar_slam_util.cpp:192-216).

    Args:
      observed: (4, 2) detected corner positions, centered coords.
    """
    projected = project_corners(camera, inv_cap_pose, tag_pose, aruco_size,
                                distortion)
    return (projected - observed).reshape(8)


def reprojection_residuals(camera, inv_cap_poses, tag_poses, blocks, aruco_size):
    """Batched residuals over a padded block table.

    Args:
      camera: (3,) shared intrinsics.
      inv_cap_poses: (C, 6) inverse capture poses.
      tag_poses: (T, 6) tag poses.
      blocks: dict with ``cap_idx`` (B,) int, ``tag_idx`` (B,) int,
        ``corners`` (B, 4, 2) observed centered coords, ``mask`` (B,) bool.

    Returns:
      (B, 8) residuals; rows with mask False are zeroed.
    """
    import jax

    def one(cap_idx, tag_idx, corners):
        return block_residual(
            camera, inv_cap_poses[cap_idx], tag_poses[tag_idx], corners, aruco_size
        )

    r = jax.vmap(one)(blocks["cap_idx"], blocks["tag_idx"], blocks["corners"])
    return r * blocks["mask"][:, None].astype(r.dtype)
