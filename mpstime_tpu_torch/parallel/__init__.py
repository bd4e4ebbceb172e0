"""Data-parallel training over a mesh of devices, and fold/trial farming
over devices and worker processes (counterpart of
``mpstime_tpu/parallel``)."""

from .mesh import (Mesh, make_mesh, mesh_platform, replicate,
                   shard_train_arrays, sharded_full_sweep,
                   sharded_full_sweep_warm, sharded_full_sweeps)
from .farm import DeviceFarm, resolve_devices, resolve_process_farm
from .procfarm import ProcessFarm

__all__ = ["Mesh", "make_mesh", "mesh_platform", "shard_train_arrays",
           "replicate", "sharded_full_sweeps", "sharded_full_sweep",
           "sharded_full_sweep_warm", "DeviceFarm", "resolve_devices",
           "ProcessFarm", "resolve_process_farm"]
