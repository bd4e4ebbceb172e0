"""Fold/trial farming across local devices (counterpart of
``mpstime_tpu/parallel/farm.py``).

The reference distributes hyperopt CV folds and outer evaluation folds to
Distributed.jl worker processes (``pmap`` + ``CachingPool``, tuning.jl:112,
evaluate.jl:281-286; worker-pool partitioning ``divide_procs``,
hyperopt_utils.jl:49-60).  Here each fold job (a whole ``fit_mps`` +
``eval_loss``, far too small to need more than one card) runs on one torch
device from a thread-per-device pool that drains a shared job queue.  A job
gets its device as an argument, ``fn(item, device)``: there is no global
default device to fall back on.  On a card each worker thread enqueues on a
stream of its own, so two workers on one card overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional, Sequence, Union

import torch


def resolve_devices(devices: Union[None, bool, str, Sequence]
                    ) -> Optional[List[torch.device]]:
    """Normalise a ``devices`` argument: None/False -> no farming,
    True/"all" -> every local card, a device type ("cuda", "cpu") -> that
    type's devices (the CPU is one device), else a list of torch devices
    (or their names; one device may repeat)."""
    if devices is None or devices is False:
        return None
    if devices is True or (isinstance(devices, str) and devices == "all"):
        devices = "cuda"
    if isinstance(devices, str) and devices in ("cuda", "cpu"):
        if devices == "cpu":
            return [torch.device("cpu")]
        if not torch.cuda.is_available():
            raise RuntimeError("resolve_devices: no CUDA device is available")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)]
    devs = [torch.device(d) for d in devices]
    return devs if devs else None


def resolve_process_farm(devices, device="cuda"):
    """Recognise the process-backend spellings of the ``devices`` argument:
    a :class:`ProcessFarm` instance passes through; ``"processes"`` /
    ``"processes:N"`` builds one (N workers; default min(4, cpu_count))
    whose workers run their jobs on ``device``, the caller's.  Returns None
    for every device-backend spelling."""
    from .procfarm import ProcessFarm

    if isinstance(devices, ProcessFarm):
        return devices
    if isinstance(devices, str) and (devices == "processes"
                                     or devices.startswith("processes:")):
        n = int(devices.split(":", 1)[1]) if ":" in devices else 0
        return ProcessFarm(n, platform=str(torch.device(device)))
    return None


def divide_devices(devices: Sequence, njobs: int) -> List[List]:
    """Partition a device list into ``njobs`` sublists (the reference's
    ``divide_procs``, hyperopt_utils.jl:49-60): with more devices than jobs
    each job gets a roughly-equal contiguous chunk (so its inner work can
    farm over the chunk); with fewer, devices are dealt round-robin, one
    per job."""
    devs = list(devices)
    if njobs <= 0:
        return []
    if len(devs) <= njobs:
        return [[devs[i % len(devs)]] for i in range(njobs)]
    q, r = divmod(len(devs), njobs)
    out, start = [], 0
    for i in range(njobs):
        size = q + (1 if i < r else 0)
        out.append(devs[start:start + size])
        start += size
    return out


def _run_on(dev: torch.device, fn: Callable[[Any, torch.device], Any], it):
    """``fn(it, dev)``; on a card, with ``dev`` current and on a stream of
    the calling thread's own, synchronised before the result is handed
    back."""
    if dev.type != "cuda":
        return fn(it, dev)
    with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
        out = fn(it, dev)
        torch.cuda.current_stream(dev).synchronize()
    return out


class DeviceFarm:
    """Run independent jobs round-robin across a set of local devices.

    ``map(fn, items)`` calls ``fn(item, device)``.  ``DeviceFarm(None)`` is
    the sequential degenerate on one card; ``DeviceFarm("all")`` farms over
    every local card; ``DeviceFarm(["cuda:0", "cuda:0"])`` runs two jobs at
    once on one card, ``DeviceFarm(["cpu", "cpu"])`` two on the CPU.
    Results keep the input order.  The first exception wins: the remaining
    queued jobs are cancelled and the exception re-raised on the caller.
    """

    def __init__(self, devices: Union[None, bool, str, Sequence] = "all"):
        devs = resolve_devices(devices)
        self.devices = devs if devs else [torch.device("cuda", 0)]

    def map(self, fn: Callable[[Any, torch.device], Any], items) -> List[Any]:
        items = list(items)
        if len(self.devices) <= 1 or len(items) <= 1:
            return [_run_on(self.devices[0], fn, it) for it in items]

        jobq: "queue.Queue" = queue.Queue()
        for i, it in enumerate(items):
            jobq.put((i, it))
        results: List[Any] = [None] * len(items)
        errors: List[BaseException] = []

        def worker(dev):
            while not errors:
                try:
                    i, it = jobq.get_nowait()
                except queue.Empty:
                    return
                try:
                    results[i] = _run_on(dev, fn, it)
                except BaseException as e:          # handed to the caller
                    errors.append(e)
                    return

        threads = [threading.Thread(target=worker, args=(d,), daemon=True)
                   for d in self.devices[:len(items)]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
