"""Device meshes for data-parallel training (counterpart of
``mpstime_tpu/parallel/mesh.py``).

The sample axis N is sharded across a 1-D mesh of devices and the MPS is
replicated; every bond update sums the shards' [C, chi*d, d, chi] gradients
once, and nothing else crosses devices.  The JAX package runs the sweep
under ``shard_map`` with one ``psum`` per bond.  Here ONE process drives
every device of the mesh, as JAX's single controller does, rather than
``torch.distributed`` with a process per GPU: a mesh is an ordered list of
torch devices in which a device may appear more than once, so one card (or
the CPU) holds several shards, and ``Mesh.all_reduce`` sums the shards'
values in shard order on the mesh's first device and copies the sum to
every other device of the mesh.  The order is fixed, so runs repeat bit for
bit.  The replicated work (the step, the QR, the split) runs once on each
distinct device of the mesh, its replicas.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"a mesh holds cpu or cuda devices, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev}: no CUDA device is available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"mesh device {dev}: only "
                         f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


class Mesh:
    """A 1-D data-parallel mesh: ``devices[s]`` holds shard s of the sample
    axis.  ``replicas`` are its distinct devices in order of first
    appearance, each holding one copy of the replicated state; ``devices[0]``
    is the home of every reduction and of the trained model.
    ``reductions`` counts ``all_reduce`` calls."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_resolve(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.replicas = tuple(dict.fromkeys(self.devices))
        self._replica_of = tuple(self.replicas.index(d) for d in self.devices)
        self.reductions = 0

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def to_shards(self, per_replica: Sequence) -> list:
        """One value per shard from one per replica: each shard's device's
        copy."""
        return [per_replica[r] for r in self._replica_of]

    def all_reduce(self, parts: Sequence) -> list:
        """The sum of one value per shard (a tensor, or a tuple of tensors),
        taken in shard order on ``devices[0]``; returns one copy per replica,
        on the replica's device."""
        if len(parts) != len(self.devices):
            raise ValueError(f"{len(parts)} values for {len(self)} shards")
        self.reductions += 1
        home = self.devices[0]

        def total(xs):
            acc = xs[0]
            for x in xs[1:]:
                acc = acc + x.to(home)
            return acc

        if isinstance(parts[0], tuple):
            sums = tuple(total(xs) for xs in zip(*parts))
            return [tuple(t.to(dev) for t in sums) for dev in self.replicas]
        s = total(parts)
        return [s.to(dev) for dev in self.replicas]

    def synchronize(self) -> None:
        """Wait for the work queued on every CUDA device of the mesh."""
        for dev in self.replicas:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A mesh of the first ``n_devices`` CUDA devices (all of them by
    default), one shard each.  Raises without enough CUDA devices; a CPU
    mesh is ``Mesh(["cpu"] * n)`` and several shards on one card
    ``Mesh(["cuda:0"] * n)``."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"requested {n} devices, have {count}")
    return Mesh([f"cuda:{i}" for i in range(n)])


def shard_train_arrays(mesh: Mesh, phis_c: torch.Tensor,
                       y_onehot: torch.Tensor, class_weight: torch.Tensor):
    """The training tensors split on the sample axis, shard s on
    ``mesh.devices[s]``: (phis_c [T, N/n, d], y_onehot [N/n, C],
    class_weight [N/n]) as lists over the shards.  N must be a multiple of
    the mesh size (``fit_mps`` pads it with zero-weight copies)."""
    n, N = len(mesh), y_onehot.shape[0]
    if N % n:
        raise ValueError(f"{N} samples do not split into {n} equal shards")
    rows = N // n

    def split(x, axis):
        return [x.narrow(axis, s * rows, rows).to(dev).contiguous()
                for s, dev in enumerate(mesh.devices)]

    return split(phis_c, 1), split(y_onehot, 0), split(class_weight, 0)


def replicate(mesh: Mesh, *arrays: torch.Tensor):
    """Each tensor as a list with one copy per replica of ``mesh``."""
    out = tuple([a.to(dev) for dev in mesh.replicas] for a in arrays)
    return out if len(out) != 1 else out[0]


def mesh_platform(mesh: Mesh) -> str:
    """The device type of the mesh's first device: "cuda" or "cpu"."""
    return mesh.devices[0].type


def _replicated(mesh: Mesh, x) -> List[torch.Tensor]:
    return x if isinstance(x, list) else replicate(mesh, x)


def _placed(mesh: Mesh, cores, center, phis_c, y_onehot, class_weight):
    """Replicated cores and center and sharded batch tensors, from tensors
    or from what ``replicate`` and ``shard_train_arrays`` return."""
    batch = (phis_c, y_onehot, class_weight)
    if not isinstance(phis_c, list):
        batch = shard_train_arrays(mesh, *batch)
    return (_replicated(mesh, cores), _replicated(mesh, center)) + batch


def sharded_full_sweeps(mesh: Mesh, cores, center, phis_c, y_onehot,
                        class_weight, eta, cutoff, **statics):
    """``training.sweep.full_sweeps`` over ``mesh``: cores and center
    replicated, the batch tensors sharded on the sample axis (tensors, or
    placed first with ``replicate`` / ``shard_train_arrays``).  statics =
    nsweeps / loss / bbopt / update_iters / rescale / svd_alg / ...
    Returns (cores, center) on the mesh's first device."""
    from ..training.sweep import full_sweeps
    return full_sweeps(*_placed(mesh, cores, center, phis_c, y_onehot,
                                class_weight), eta, cutoff, mesh=mesh,
                       **statics)


def sharded_full_sweep_warm(mesh: Mesh, cores, center, subspaces, phis_c,
                            y_onehot, class_weight, eta, cutoff, *,
                            track_cost: bool = False, **statics):
    """One warm sweep (``svd_alg`` "randomized_warm" or the ritz route)
    over ``mesh`` from the subspace caches ``subspaces`` = (VB, UF).
    Returns (cores, center, subspaces[, costs]) on the mesh's first
    device."""
    from ..training.sweep import sweep_once
    cores, center, (VB, UF), costs = sweep_once(
        *_placed(mesh, cores, center, phis_c, y_onehot, class_weight), eta,
        cutoff, subspaces=tuple(_replicated(mesh, s) for s in subspaces),
        mesh=mesh, track_cost=track_cost, **statics)
    out = (cores[0], center[0], (VB[0], UF[0]))
    return out + ((costs,) if track_cost else ())


def sharded_full_sweep(mesh: Mesh, cores, center, phis_c, y_onehot,
                       class_weight, eta, cutoff, *, track_cost: bool = False,
                       **statics):
    """One sweep of a split without subspace caches over ``mesh``.  Returns
    (cores, center[, costs]) on the mesh's first device."""
    from ..training.sweep import sweep_once
    cores, center, _, costs = sweep_once(
        *_placed(mesh, cores, center, phis_c, y_onehot, class_weight), eta,
        cutoff, mesh=mesh, track_cost=track_cost, **statics)
    return (cores[0], center[0]) + ((costs,) if track_cost else ())
