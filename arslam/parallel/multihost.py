"""Multi-controller (multi-host) support for the distributed solver.

The reference's data plane is single-process DDS pub/sub (SURVEY.md §2.3);
the baseline instead asks for distributed BA at "N >= 2 hosts".  In
multi-controller JAX every host runs the same program over a global mesh
but may only place data on, and read data from, its *addressable* devices.
These helpers make the tag-sharded solver (`parallel/dist_lm.py`)
placement-agnostic:

- ``put_global(arr, sharding)``: ``jax.device_put`` when the sharding is
  fully addressable (single process — the common case); otherwise each
  process materializes only its shards via ``jax.make_array_from_callback``.
  The host-side graph store is deterministic and replicated per process, so
  every process holds the full numpy operand and can serve any index.
- ``fetch(arr)``: device -> host numpy regardless of process span.  Fully
  replicated or fully addressable arrays read locally; tag-sharded state
  all-gathers (one collective per *solve*, not per iteration).
- ``initialize(spec)``: thin ``jax.distributed.initialize`` wrapper for the
  CLI (``--multihost coordinator:port,num_processes,process_id``; bare
  ``--multihost auto`` where the cluster runtime autodetects, e.g. SLURM).

Every process must execute the same sequence of device programs — the wave
drivers guarantee that because the graph bookkeeping (BFS order, seed
choice, activity masks) is a pure function of the shared input detections.

Tested for real (2 separate processes, gloo CPU collectives) in
``tests/test_multihost.py``.
"""

from __future__ import annotations

import jax
import numpy as np

__all__ = ["initialize", "put_global", "fetch", "is_multiprocess"]


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def put_global(arr, sharding):
    """Place a (process-local, fully materialized) numpy array onto a
    global sharding, whether or not this process addresses every shard."""
    arr = np.asarray(arr)
    if sharding.is_fully_addressable:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def fetch(arr):
    """Device array -> host numpy, regardless of process span."""
    if isinstance(arr, (np.ndarray, np.generic)):
        return arr
    if getattr(arr, "is_fully_replicated", True) or \
            getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def initialize(spec: str | None = None):
    """Join the multi-controller runtime.

    ``spec`` is ``coordinator:port,num_processes,process_id`` (explicit —
    e.g. localhost simulation or a GPU cluster) or ``auto``/None for
    environments where ``jax.distributed.initialize`` autodetects (SLURM).
    Call before any device use.
    """
    if spec and spec != "auto":
        parts = spec.rsplit(",", 2)
        if len(parts) != 3:
            raise ValueError(
                "--multihost expects coordinator:port,num_processes,"
                f"process_id or 'auto'; got {spec!r}")
        coordinator, num, pid = parts[0], int(parts[1]), int(parts[2])
        jax.distributed.initialize(coordinator, num_processes=num,
                                   process_id=pid)
    else:
        jax.distributed.initialize()
    return jax.process_index(), jax.process_count()
