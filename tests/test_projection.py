"""Projection model tests: closed-form cases + an independent NumPy oracle
implementing the reference math (projectCorner, ar_slam_util.cpp:131-172)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from arslam.core import projection

ARUCO_SIZE = 0.0635
RNG = np.random.default_rng(7)


def oracle_project(camera, inv_cap_pose, tag_pose, aruco_size=ARUCO_SIZE):
    """Straight NumPy/scipy transcription of the documented math."""
    camera = np.array(camera, dtype=float)
    inv_cap_pose = np.array(inv_cap_pose, dtype=float)
    tag_pose = np.array(tag_pose, dtype=float)
    dirs = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=float)
    corners = np.concatenate(
        [0.5 * aruco_size * dirs, np.zeros((4, 1))], axis=1
    )
    r_tag = Rotation.from_rotvec(tag_pose[3:6])
    p_w = r_tag.apply(corners) + tag_pose[0:3]
    r_inv = Rotation.from_rotvec(inv_cap_pose[3:6])
    p_c = r_inv.apply(p_w + inv_cap_pose[0:3])
    return camera[0] * p_c[:, 0:2] / p_c[:, 2:3]


def test_identity_pose_centered_tag():
    """Tag at z=1 in front of an identity camera projects symmetrically."""
    cam = jnp.array([3000.0, 0.0, 0.0])
    inv_cap = jnp.zeros(6)
    tag = jnp.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    uv = projection.project_corners(cam, inv_cap, tag, ARUCO_SIZE)
    half = 3000.0 * 0.5 * ARUCO_SIZE
    expect = np.array([[-half, -half], [half, -half], [half, half], [-half, half]])
    np.testing.assert_allclose(uv, expect, atol=1e-9)


def test_translation_shifts_projection():
    cam = jnp.array([3000.0, 0.0, 0.0])
    inv_cap = jnp.zeros(6)
    tag = jnp.array([0.1, -0.05, 2.0, 0.0, 0.0, 0.0])
    uv = np.asarray(projection.project_corners(cam, inv_cap, tag, ARUCO_SIZE))
    center = uv.mean(axis=0)
    np.testing.assert_allclose(center, [3000 * 0.1 / 2.0, 3000 * -0.05 / 2.0], atol=1e-6)


@pytest.mark.f64_oracle
def test_matches_oracle_random_poses():
    for _ in range(20):
        cam = np.array([RNG.uniform(500, 4000), 0.0, 0.0])
        tag = np.concatenate(
            [RNG.normal(scale=0.5, size=2), [RNG.uniform(0.5, 3.0)], RNG.normal(scale=0.6, size=3)]
        )
        inv_cap = np.concatenate(
            [RNG.normal(scale=0.3, size=3), RNG.normal(scale=0.4, size=3)]
        )
        got = projection.project_corners(
            jnp.array(cam), jnp.array(inv_cap), jnp.array(tag), ARUCO_SIZE
        )
        expect = oracle_project(cam, inv_cap, tag)
        np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-9)


def test_block_residual_zero_for_exact_observation():
    cam = jnp.array([3000.0, 0.0, 0.0])
    inv_cap = jnp.array([0.1, 0.2, 0.3, 0.05, -0.1, 0.2])
    tag = jnp.array([0.0, 0.1, 1.5, 0.3, 0.0, -0.2])
    observed = projection.project_corners(cam, inv_cap, tag, ARUCO_SIZE)
    r = projection.block_residual(cam, inv_cap, tag, observed, ARUCO_SIZE)
    np.testing.assert_allclose(r, np.zeros(8), atol=1e-10)


@pytest.mark.f64_oracle
def test_residual_jacobian_matches_finite_difference():
    cam = jnp.array([3000.0, 0.0, 0.0])
    inv_cap = jnp.array([0.1, 0.2, 0.3, 0.05, -0.1, 0.2])
    tag = jnp.array([0.0, 0.1, 1.5, 0.3, 0.0, -0.2])
    observed = jnp.asarray(oracle_project(np.asarray(cam), np.asarray(inv_cap), np.asarray(tag)))

    def r(cam, inv_cap, tag):
        return projection.block_residual(cam, inv_cap, tag, observed, ARUCO_SIZE)

    jac = jax.jacfwd(r, argnums=(0, 1, 2))(cam, inv_cap, tag)
    eps = 1e-7
    for argnum, x in [(0, cam), (1, inv_cap), (2, tag)]:
        num = np.zeros((8, x.shape[0]))
        for j in range(x.shape[0]):
            dx = np.zeros(x.shape[0])
            dx[j] = eps
            args_hi = [cam, inv_cap, tag]
            args_lo = [cam, inv_cap, tag]
            args_hi[argnum] = x + dx
            args_lo[argnum] = x - dx
            num[:, j] = (np.asarray(r(*args_hi)) - np.asarray(r(*args_lo))) / (2 * eps)
        np.testing.assert_allclose(jac[argnum], num, rtol=2e-5, atol=2e-4)


def test_batched_residuals_with_mask():
    cam = jnp.array([3000.0, 0.0, 0.0])
    caps = jnp.array([[0.0] * 6, [0.1, 0, 0, 0, 0, 0]])
    tags = jnp.array([[0, 0, 1.0, 0, 0, 0], [0.2, 0, 1.5, 0, 0, 0.4]])
    obs0 = projection.project_corners(cam, caps[0], tags[0], ARUCO_SIZE)
    blocks = {
        "cap_idx": jnp.array([0, 1, 0]),
        "tag_idx": jnp.array([0, 1, 1]),
        "corners": jnp.stack([obs0, obs0, obs0]),
        "mask": jnp.array([True, True, False]),
    }
    r = projection.reprojection_residuals(cam, caps, tags, blocks, ARUCO_SIZE)
    assert r.shape == (3, 8)
    np.testing.assert_allclose(r[0], np.zeros(8), atol=1e-9)
    assert np.abs(np.asarray(r[1])).max() > 0  # wrong pose -> nonzero
    np.testing.assert_allclose(r[2], np.zeros(8))  # masked out
