"""Unit tests for axis-angle algebra against scipy.spatial.transform as an
independent oracle, plus autodiff safety at theta = 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from arslam.core import lie

RNG = np.random.default_rng(42)



# every test here pins the lie math against scipy/closed forms at f64
# tolerances (1e-8..1e-15): CPU-only by design (see the f64_oracle marker)
pytestmark = pytest.mark.f64_oracle

def random_aa(scale=np.pi * 0.9):
    v = RNG.normal(size=3)
    v = v / np.linalg.norm(v)
    return v * RNG.uniform(0.01, scale)


@pytest.mark.parametrize("trial", range(10))
def test_rotate_matches_scipy(trial):
    aa = random_aa()
    p = RNG.normal(size=3)
    expect = Rotation.from_rotvec(aa).apply(p)
    got = lie.axis_angle_rotate(jnp.array(aa), jnp.array(p))
    np.testing.assert_allclose(got, expect, atol=1e-12)


def test_rotate_zero_angle():
    p = jnp.array([1.0, 2.0, 3.0])
    got = lie.axis_angle_rotate(jnp.zeros(3), p)
    np.testing.assert_allclose(got, p, atol=1e-15)


def test_rotate_tiny_angle_matches_series():
    aa = np.array([1e-8, -2e-8, 0.5e-8])
    p = RNG.normal(size=3)
    expect = Rotation.from_rotvec(aa).apply(p)
    got = lie.axis_angle_rotate(jnp.array(aa), jnp.array(p))
    np.testing.assert_allclose(got, expect, atol=1e-14)


def test_rotate_grad_finite_at_zero():
    p = jnp.array([1.0, 2.0, 3.0])
    g = jax.jacfwd(lambda a: lie.axis_angle_rotate(a, p))(jnp.zeros(3))
    assert np.all(np.isfinite(g))
    # d(Rp)/daa at aa=0 is -[p]_x (skew of p), since R≈I+[aa]_x
    skew = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
    np.testing.assert_allclose(g, -skew.T * -1 @ np.eye(3) * 1, atol=1e-8, rtol=0)
    # equivalently g[i,j] = d(R p)_i/d aa_j = -skew(p)[i,j]
    np.testing.assert_allclose(np.asarray(g), -skew, atol=1e-8)


@pytest.mark.parametrize("trial", range(10))
def test_quaternion_roundtrip(trial):
    aa = random_aa()
    q = lie.axis_angle_to_quaternion(jnp.array(aa))
    # scipy quat is (x,y,z,w)
    sq = Rotation.from_rotvec(aa).as_quat()
    np.testing.assert_allclose(np.asarray(q), [sq[3], sq[0], sq[1], sq[2]], atol=1e-12)
    back = lie.quaternion_to_axis_angle(q)
    np.testing.assert_allclose(back, aa, atol=1e-12)


def test_quaternion_roundtrip_zero():
    q = lie.axis_angle_to_quaternion(jnp.zeros(3))
    np.testing.assert_allclose(q, [1.0, 0, 0, 0], atol=1e-15)
    np.testing.assert_allclose(lie.quaternion_to_axis_angle(q), np.zeros(3), atol=1e-15)


@pytest.mark.parametrize("trial", range(10))
def test_compose_matches_scipy(trial):
    a, b = random_aa(), random_aa()
    got = lie.compose_axis_angle(jnp.array(a), jnp.array(b))
    # q(a) * q(b) applies b first then a:  R = Ra @ Rb
    expect = (Rotation.from_rotvec(a) * Rotation.from_rotvec(b)).as_rotvec()
    np.testing.assert_allclose(got, expect, atol=1e-11)


def test_compose_with_inverse_is_identity():
    a = random_aa()
    got = lie.compose_axis_angle(jnp.array(a), lie.invert_axis_angle(jnp.array(a)))
    np.testing.assert_allclose(got, np.zeros(3), atol=1e-12)


def test_compose_grad_finite_everywhere():
    a = jnp.array(random_aa())
    g = jax.jacfwd(lie.compose_axis_angle)(jnp.zeros(3), a)
    assert np.all(np.isfinite(np.asarray(g)))
    g2 = jax.jacfwd(lie.compose_axis_angle)(a, jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(g2)))


def test_normalize_angle():
    angles = np.array([0.0, np.pi - 1e-9, -np.pi, 3 * np.pi, -7.5 * np.pi, 12.3])
    got = lie.normalize_angle(jnp.array(angles))
    expect = np.mod(np.mod(angles, 2 * np.pi) + 3 * np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(got, expect, atol=1e-12)
    assert np.all(np.asarray(got) >= -np.pi) and np.all(np.asarray(got) < np.pi)
