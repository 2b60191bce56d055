"""REAL multi-process (multi-controller) distributed BA test.

Unlike tests/test_dist.py (virtual 8-device mesh inside ONE process), this
spawns 2 separate Python processes that join one jax.distributed runtime
over localhost (gloo CPU collectives) and run the tag-sharded solve over a
global mesh where each controller addresses only its own device — the same
placement regime as a real multi-host cluster (SURVEY.md §5.8).
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_solve_matches_single_device():
    nproc = 2
    port = _free_port()
    env = dict(os.environ)
    # one local CPU device per process -> collectives MUST cross processes
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(pid), str(nproc)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" +
                    "\n---\n".join(outs))

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"worker {pid} output:\n{out}"

    # both controllers must report the identical optimum
    costs = {line.split("cost=")[1]
             for out in outs for line in out.splitlines()
             if "MULTIHOST_OK" in line}
    assert len(costs) == 1, costs


@pytest.mark.slow
def test_cli_multihost_resolve(tmp_path):
    """`arslam map map.yaml --multihost ...` run as 2 identical controller
    processes: re-solves the demo map over the cross-process mesh; process 0
    publishes the artifact, the secondary controller's output goes to
    scratch (cli._maybe_multihost)."""
    import numpy as np
    import yaml

    from arslam.graph import MapStore, save_yaml

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    with open(os.path.join(fixtures, "demo_detections.yaml")) as f:
        data = yaml.safe_load(f)
    store = MapStore()
    for cap in data["captures"][:3]:
        dets = [(d["id"], np.array(d["corners"]).reshape(4, 2))
                for d in cap["detections"]["4X4_50"]]
        store.add_detections(cap["uid"], dets,
                             (cap["width"], cap["height"]), cap["img_fn"])
    map_in = tmp_path / "unsolved.yaml"
    with open(map_in, "w") as f:
        save_yaml(store, f)

    out_fn = tmp_path / "solved.yaml"
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "arslam.cli", "map", str(map_in),
             "-o", str(out_fn), "--platform", "cpu",
             "--multihost", f"127.0.0.1:{port},2,{pid}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=str(tmp_path),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("CLI multihost timed out:\n" + "\n---\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"controller {pid} failed:\n{out}"
    # only process 0 prints the summary (stdout) / writes the artifact
    assert "px -> " in outs[0]
    assert "px -> " not in outs[1]
    with open(out_fn) as f:
        solved = yaml.safe_load(f)
    # the solve moved the poses off zero
    poses = np.array([c["inv_pose"] for c in solved["captures"].values()])
    assert np.abs(poses).max() > 1e-3
