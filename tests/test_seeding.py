"""Seeding heuristics: consistency (seed then project lands near the
observation) and inverse-consistency between init_capture_pose and
init_ar_pose, mirroring the reference semantics (ar_slam_util.cpp:52-128)."""

import jax.numpy as jnp
import numpy as np
import pytest

from arslam.core import projection, seeding

ARUCO_SIZE = 0.0635


def test_calc_init_values_frontal_tag():
    """A frontal, unrotated tag at depth z yields (x, y, z, 0)."""
    cam = jnp.array([3000.0, 0.0, 0.0])
    tag = jnp.array([0.05, -0.02, 1.7, 0.0, 0.0, 0.0])
    obs = projection.project_corners(cam, jnp.zeros(6), tag, ARUCO_SIZE)
    vals = np.asarray(seeding.calc_init_values(obs, 3000.0, ARUCO_SIZE))
    # max-edge depth estimate is biased slightly short for off-center tags;
    # frontal centered-ish tag: accurate to a few percent
    np.testing.assert_allclose(vals[2], 1.7, rtol=0.05)
    np.testing.assert_allclose(vals[0], 0.05, atol=0.01)
    np.testing.assert_allclose(vals[1], -0.02, atol=0.01)
    np.testing.assert_allclose(vals[3], 0.0, atol=1e-6)


def test_calc_init_values_in_plane_rotation():
    cam = jnp.array([3000.0, 0.0, 0.0])
    rz = 0.4
    tag = jnp.array([0.0, 0.0, 1.0, 0.0, 0.0, rz])
    obs = projection.project_corners(cam, jnp.zeros(6), tag, ARUCO_SIZE)
    vals = np.asarray(seeding.calc_init_values(obs, 3000.0, ARUCO_SIZE))
    np.testing.assert_allclose(vals[3], rz, atol=1e-6)


def test_init_capture_pose_reprojects_near_observation():
    """Seed a capture from a known frontal tag; reprojection through the
    seeded pose must land close to the observed rect."""
    cam = jnp.array([3000.0, 0.0, 0.0])
    tag = jnp.array([0.3, -0.1, 0.0, 0.0, 0.0, 0.25])
    true_inv_cap = jnp.array([0.05, 0.02, 2.0, 0.0, 0.0, 0.1])
    obs = projection.project_corners(cam, true_inv_cap, tag, ARUCO_SIZE)
    seeded = seeding.init_capture_pose(obs, cam, tag, ARUCO_SIZE)
    reproj = projection.project_corners(cam, seeded, tag, ARUCO_SIZE)
    err = np.abs(np.asarray(reproj) - np.asarray(obs)).max()
    assert err < 5.0, f"seed reprojection error {err} px too large"


def test_init_ar_pose_reprojects_near_observation():
    cam = jnp.array([3000.0, 0.0, 0.0])
    inv_cap = jnp.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    true_tag = jnp.array([0.1, 0.2, 1.4, 0.0, 0.0, -0.3])
    obs = projection.project_corners(cam, inv_cap, true_tag, ARUCO_SIZE)
    seeded = seeding.init_ar_pose(obs, cam, inv_cap, ARUCO_SIZE)
    reproj = projection.project_corners(cam, inv_cap, seeded, ARUCO_SIZE)
    err = np.abs(np.asarray(reproj) - np.asarray(obs)).max()
    assert err < 5.0, f"seed reprojection error {err} px too large"


@pytest.mark.f64_oracle
def test_init_roundtrip_capture_then_tag():
    """init_capture_pose and init_ar_pose are mutually consistent: seeding a
    tag from a capture seeded from that tag recovers the tag pose."""
    cam = jnp.array([3000.0, 0.0, 0.0])
    tag = jnp.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    inv_cap = jnp.array([0.0, 0.0, 1.8, 0.0, 0.0, 0.2])
    obs = projection.project_corners(cam, inv_cap, tag, ARUCO_SIZE)
    seeded_cap = seeding.init_capture_pose(obs, cam, tag, ARUCO_SIZE)
    seeded_tag = seeding.init_ar_pose(obs, cam, seeded_cap, ARUCO_SIZE)
    np.testing.assert_allclose(np.asarray(seeded_tag), np.asarray(tag), atol=1e-9)


@pytest.mark.f64_oracle
def test_multi_anchor_single_is_reference_seed():
    """seed_anchors="multi" with exactly ONE valid anchor must reduce
    bit-identically to the reference's single-init_block seed
    (seed_capture_pose; ar_slam_util.cpp:803-807) — the parity guarantee
    claimed at core/seeding.py's one-anchor fast-out."""
    cam = jnp.array([3000.0, 0.0, 0.0])
    tag = jnp.array([0.3, -0.1, 0.0, 0.05, -0.02, 0.25])
    true_inv_cap = jnp.array([0.05, 0.02, 2.0, 0.01, -0.03, 0.1])
    obs = projection.project_corners(cam, true_inv_cap, tag, ARUCO_SIZE)

    for mode in ("frontal", "hybrid"):
        single = seeding.seed_capture_pose(obs, cam, tag, ARUCO_SIZE,
                                           mode=mode)
        # one valid anchor in a non-zero slot, garbage in the masked slots
        corners = jnp.stack([obs + 999.0, obs, obs * 0.0])
        tags = jnp.stack([tag * 0.0, tag, tag + 1.0])
        mask = jnp.array([False, True, False])
        multi = seeding.seed_capture_pose_multi(corners, cam, tags, mask,
                                                ARUCO_SIZE, mode=mode)
        np.testing.assert_array_equal(np.asarray(multi), np.asarray(single))
