"""Multi-controller worker for tests/test_multihost.py.

Run as ``python multihost_worker.py PORT PROCESS_ID NUM_PROCESSES``.  Every
process executes this same program (the multi-controller contract,
parallel/multihost.py): builds the identical synthetic problem, solves it
single-device as the local reference, then solves it distributed over the
GLOBAL mesh spanning all processes' devices, and asserts they match.

Pins the cpu platform through jax.config, so the workers never open a GPU
the host may have.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                           process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == nproc * jax.local_device_count()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from arslam.graph import export_arrays  # noqa: E402
from arslam.parallel import block_mesh, lm_solve_dist  # noqa: E402
from arslam.solve import lm_solve  # noqa: E402
from arslam.solve.lm import LMConfig  # noqa: E402
from arslam.utils.synthetic import make_synthetic_map  # noqa: E402

ARUCO_SIZE = 0.0635

store, truth = make_synthetic_map(n_tags=8, n_caps=4, seed=9, noise_px=0.3)
for cap in store.captures:
    cap.inv_pose[:] = truth["cap_poses"][int(cap.uid.split("_")[1])]
for tag in store.arucos:
    tag.pose[:] = truth["tag_poses"][int(tag.id.split("_")[-1])]
arrs = export_arrays(store)
rng = np.random.default_rng(0)
cap_poses = arrs.cap_poses + rng.normal(scale=0.002, size=arrs.cap_poses.shape)
tag_poses = arrs.tag_poses + rng.normal(scale=0.002, size=arrs.tag_poses.shape)
config = LMConfig(max_iterations=8)

# local single-device reference (no collectives; identical on every process)
cam1, caps1, tags1, info1 = lm_solve(
    jnp.asarray(arrs.camera), jnp.asarray(cap_poses), jnp.asarray(tag_poses),
    jnp.asarray(arrs.cap_idx), jnp.asarray(arrs.tag_idx),
    jnp.asarray(arrs.corners), jnp.asarray(arrs.block_mask),
    jnp.asarray(True), jnp.asarray(arrs.cap_mask), jnp.asarray(arrs.tag_mask),
    aruco_size=ARUCO_SIZE, config=config,
)

# global mesh across processes: each controller addresses only its own
# devices; placement goes through multihost.put_global, results come back
# via multihost.fetch (process_allgather)
mesh = block_mesh()
assert mesh.devices.size == jax.device_count()
cam2, caps2, tags2, info2 = lm_solve_dist(
    mesh, arrs.camera, cap_poses, tag_poses, arrs.cap_idx, arrs.tag_idx,
    arrs.corners, arrs.block_mask, np.asarray(True), arrs.cap_mask,
    arrs.tag_mask, aruco_size=ARUCO_SIZE, config=config,
)

np.testing.assert_allclose(float(info1["cost"]), float(info2["cost"]),
                           rtol=1e-7)
np.testing.assert_allclose(np.asarray(cam1), np.asarray(cam2), rtol=1e-6)
np.testing.assert_allclose(np.asarray(caps1), np.asarray(caps2),
                           rtol=1e-4, atol=1e-8)
np.testing.assert_allclose(np.asarray(tags1), np.asarray(tags2),
                           rtol=1e-4, atol=1e-8)

# full BFS wave driver (seeding + incremental attach + per-wave LM +
# write_back) through the same cross-process mesh — exercises the
# _WaveRunner distributed path's placements and fetches end to end
from arslam.config import ArSlamConfig, SolverConfig  # noqa: E402
from arslam.solve.batch import solve  # noqa: E402

cfg = ArSlamConfig(solver=SolverConfig(max_iterations=15, dtype="float64"))
s1, _ = make_synthetic_map(n_tags=6, n_caps=3, seed=3, noise_px=0.3)
out1 = solve(s1, cfg)
s2, _ = make_synthetic_map(n_tags=6, n_caps=3, seed=3, noise_px=0.3)
out2 = solve(s2, cfg, mesh=mesh)
assert out1["waves"] == out2["waves"]
np.testing.assert_allclose(out1["rmse"], out2["rmse"], rtol=1e-5)
for c1, c2 in zip(s1.captures, s2.captures):
    np.testing.assert_allclose(c1.inv_pose, c2.inv_pose, rtol=1e-3,
                               atol=1e-6)

print(f"MULTIHOST_OK pid={pid} cost={float(info2['cost']):.12g} "
      f"rmse={out2['rmse']:.12g}", flush=True)
