"""Data-parallel Aruco detection over a device mesh.

The reference scales detection by running one detector NODE per dictionary
on host threads (ar_slam_launch.py:75-95) — two cores of parallelism, per
image, per dictionary.  Here the whole detector is already one fused batched
device program (detect/device_detect.py), so the natural scaling axis is the
IMAGE axis: shard the batch over the mesh with ``shard_map`` and every chip
runs the identical static-shape program on its slice — zero collectives in
the hot path (detection is embarrassingly data-parallel; outputs stay
sharded for the caller to consume or gather).

``shard_map`` (not auto-sharding) so each device compiles exactly the
single-device program on its local batch: no partitioning decisions inside
the detector's while loops, sorts and gathers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from arslam.detect.device_detect import DetectParams, detect_batch

IMAGE_AXIS = "images"


def image_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the image (batch) axis."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return Mesh(np.array(devices[:n_devices]), (IMAGE_AXIS,))


def detect_batch_sharded(images, *, mesh: Mesh,
                         params: DetectParams = DetectParams(),
                         dict_names=("4X4_50", "5X5_100")):
    """detect_batch with the image axis sharded over ``mesh``.

    Args:
      images: (N, H, W) grayscale; N is padded up to a multiple of the mesh
        size with zero images (their detections are all-invalid) and the
        padding is stripped from every output leaf.
      mesh: 1-D mesh whose single axis shards the image axis.

    Returns the same pytree as detect_batch, with leading axis N.
    """
    (axis,) = mesh.axis_names
    n_dev = mesh.devices.size
    n = images.shape[0]
    pad = (-n) % n_dev
    if pad:
        images = jnp.concatenate(
            [jnp.asarray(images),
             jnp.zeros((pad,) + images.shape[1:], images.dtype)])

    local = partial(detect_batch, params=params, dict_names=dict_names)
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis), out_specs=P(axis)))
    out = fn(images)
    if pad:
        out = jax.tree.map(lambda x: x[:n], out)
    return out
