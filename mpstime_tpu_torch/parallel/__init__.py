"""Data-parallel training over a mesh of devices (counterpart of
``mpstime_tpu/parallel``); the fold farms (``farm.py``, ``procfarm.py``)
come with the port of ``mpstime_tpu/hyperopt``."""

from .mesh import (Mesh, make_mesh, mesh_platform, replicate,
                   shard_train_arrays, sharded_full_sweep,
                   sharded_full_sweep_warm, sharded_full_sweeps)

__all__ = ["Mesh", "make_mesh", "mesh_platform", "shard_train_arrays",
           "replicate", "sharded_full_sweeps", "sharded_full_sweep",
           "sharded_full_sweep_warm"]
