"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to run
without a GPU.  The full-size run is ``python chip_smoke.py`` on the card."""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_main_exits_nonzero_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(cs, "build_native",
                        lambda: {"graph": False, "jpeg": False})
    assert cs.main([]) != 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("card: ")  # the environment line still prints
    assert not any(line.startswith("{") for line in out)  # no result


def test_main_refuses_without_the_package(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    import shutil
    import subprocess

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


@pytest.mark.parametrize("phase,kwargs", [
    ("phase_tf32", {"n": 64}),
    ("phase_demo_cold", {}),
    ("phase_dense", {"n_tags": 40, "n_caps": 16, "n_iters": 10}),
    ("phase_cg", {"n_tags": 60, "n_caps": 24, "n_iters": 10}),
    ("phase_four_dense", {"n_tags": 40, "n_caps": 16, "n_iters": 10}),
    ("phase_four_cg", {"n_tags": 60, "n_caps": 24, "n_iters": 10}),
])
def test_solver_phases_tiny(phase, kwargs):
    """Each solver phase runs end to end at a tiny size and meets its own
    bounds (the four-card phases on the suite's virtual CPU devices)."""
    checks, times, extra = getattr(cs, phase)(**kwargs)
    assert checks.rows and checks.ok, checks.line()
    assert all(np.isfinite(v) for v in times.values())
    json.dumps(extra, default=str)


def test_detect_phases_tiny(tmp_path):
    """Detection vs the renderer's truth and the NumPy oracle, the stage
    profile window, and sharded vs single detection — at small frames."""
    checks, _, extra = cs.phase_detect(0, sizes=((300, 420),), n_frames=2,
                                       n_oracle=1, profile_dir=str(tmp_path))
    assert checks.ok, checks.line()
    assert extra["420x300_markers"] > 0
    assert set(extra["420x300_stage_device_ms"]) >= {"detect_ccl", "other"}
    checks, _, _ = cs.phase_four_detect(0, n_frames=4, size=(300, 420))
    assert checks.ok, checks.line()


@pytest.mark.parametrize("op_name,scope", [
    ("jit(detect_batch)/detect_ccl/while/body/min", "detect_ccl"),
    ("jit(detect_batch)/vmap(detect_extract)/detect_refine/dot_general",
     "detect_refine"),
    ("jit(detect_batch)/vmap(detect_decode_4X4_50)/gather", "detect_decode"),
    ("broadcast_in_dim;jit(detect_batch)/vmap(detect_topk)/lt", "detect_topk"),
    ("jit(detect_batch)/detect_cclx/add", "other"),  # not a component
    ("jit(detect_batch)/sort", "other"),
])
def test_scope_of(op_name, scope):
    names = ("detect_ccl", "detect_extract",
             "detect_refine", "detect_decode", "detect_topk")
    assert cs.scope_of(op_name, names) == scope


def test_map_phase_tiny(tmp_path):
    """Rendered captures -> `arslam map` -> `arslam localize`, and the serve
    pipeline, at 960x540: the map meets its bounds; the numerics phase
    re-solves the same detections under pinned matmul precision."""
    args = dict(n_tags=36, n_caps=24, n_loc=3, image_size=(960, 540),
                focal=1500.0)
    checks, _, extra = cs.phase_map(0, str(tmp_path), **args)
    rows = {name: ok for name, _, _, ok in checks.rows}
    for name in ("cli_map_rc", "cli_localize_rc", "map_rmse_px",
                 "map_focal_rel_err", "map_tag_ate_m", "serve_rmse_px",
                 "serve_focal_rel_err", "serve_tag_ate_m"):
        assert rows[name], checks.line()
    # small tags at half resolution: pose errors are finite, not at the
    # full-size bound
    assert np.isfinite(extra["cli"]["loc_pos_err_m_max"])
    checks, _, extra = cs.phase_numerics(
        0, str(tmp_path), dense_sizes=(40, 16), n_iters=10, **args)
    assert extra["map"]["rmse_px"] < cs.MAP_RMSE_PX
