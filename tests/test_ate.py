"""ATE utility tests: alignment recovery and solver trajectory accuracy
against synthetic ground truth."""

import numpy as np
import pytest

from arslam.config import ArSlamConfig
from arslam.solve import solve_batch
from arslam.utils.ate import ate_rmse, camera_positions, umeyama_alignment
from arslam.utils.synthetic import make_synthetic_map


def test_umeyama_recovers_similarity():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20, 3))
    from scipy.spatial.transform import Rotation

    r_true = Rotation.from_rotvec([0.3, -0.2, 0.9]).as_matrix()
    s_true, t_true = 1.7, np.array([0.5, -1.0, 2.0])
    y = (s_true * (r_true @ x.T)).T + t_true
    s, r, t = umeyama_alignment(x, y)
    np.testing.assert_allclose(s, s_true, rtol=1e-10)
    np.testing.assert_allclose(r, r_true, atol=1e-10)
    np.testing.assert_allclose(t, t_true, atol=1e-10)
    assert ate_rmse(x, y) < 1e-10


def test_ate_rejects_mismatched():
    with pytest.raises(ValueError):
        ate_rmse(np.zeros((3, 3)), np.zeros((4, 3)))


def test_solver_trajectory_matches_ground_truth():
    """Solved camera trajectory aligns with the synthetic ground truth to
    sub-millimeter ATE."""
    store, truth = make_synthetic_map(n_tags=16, n_caps=10, seed=12)
    solve_batch(store, ArSlamConfig())
    solved = camera_positions(store)
    true_pos = np.stack([
        -truth["cap_poses"][int(c.uid.split("_")[1])][0:3]
        for c in store.captures
    ])
    err = ate_rmse(solved, true_pos)
    assert err < 1e-3, f"ATE {err} m"
