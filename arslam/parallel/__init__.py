"""Distributed bundle adjustment: mesh helpers, tag-sharded LM, multihost.

The solver exports are lazy (PEP 562): ``dist_lm`` transitively imports the
projection kernels, which build device constants at import time and so
initialize the XLA backend — that must not happen before
``jax.distributed.initialize()`` in multi-controller runs
(``cli._maybe_multihost`` / ``multihost.initialize``).
"""

from arslam.parallel.mesh import (  # noqa: F401
    BLOCK_AXIS,
    block_mesh,
    shard_blocks,
)
from arslam.parallel import multihost  # noqa: F401

_LAZY = {
    "TagShardedProblem": "arslam.parallel.dist_lm",
    "lm_solve_dist": "arslam.parallel.dist_lm",
    "make_dist_wave_solver": "arslam.parallel.dist_lm",
    "make_tag_sharded_hooks": "arslam.parallel.dist_lm",
    "partition_blocks": "arslam.parallel.partition",
    "prepare_tag_shards": "arslam.parallel.partition",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
