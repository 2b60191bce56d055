"""Device-mesh helpers for distributed bundle adjustment.

The scaling axis of this workload is the observation (block) axis — SURVEY.md
§5.7: per-tag Schur blocks are independent sums over that tag's observations,
so blocks shard across devices and the assembled normal equations
psum-reduce over the device interconnect (NVLink within a host).
Parameters (camera, capture poses, tag poses) are tiny and stay replicated.

Works identically on real GPUs and on the CPU virtual mesh
(``xla_force_host_platform_device_count``) used in CI.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


def block_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the block axis."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(np.array(devices[:n_devices]), (BLOCK_AXIS,))


def pad_blocks_to_multiple(arrs_dict: dict, n: int) -> dict:
    """Pad every block-axis array so the axis divides the mesh size."""
    b = arrs_dict["cap_idx"].shape[0]
    rem = (-b) % n
    if rem == 0:
        return dict(arrs_dict)
    out = {}
    for k, v in arrs_dict.items():
        pad_width = [(0, rem)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width)
    return out


def shard_blocks(mesh: Mesh, *arrays):
    """Place block-axis arrays with P('blocks') sharding."""
    sharding = NamedSharding(mesh, P(BLOCK_AXIS))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def replicate(mesh: Mesh, *arrays):
    sharding = NamedSharding(mesh, P())
    return tuple(jax.device_put(a, sharding) for a in arrays)
