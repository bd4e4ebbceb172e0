"""OS-process worker farming, the Distributed.jl analog (counterpart of
``mpstime_tpu/parallel/procfarm.py``).

The reference's distribution is process-based: ``addprocs`` spawns worker
processes and hyperopt pmaps fold/trial closures onto them through a
``CachingPool`` (tuning.jl:22,112; random_search.jl:114-116;
evaluate.jl:270-297).  :class:`ProcessFarm` is the same shape: a pool of
plain ``subprocess`` Python workers (fresh interpreters, never forked: a
CUDA context does not survive fork; and not ``multiprocessing`` spawn,
whose main-module re-import breaks unguarded user scripts), connected over
an authenticated local socket.  Job closures ship via cloudpickle (imported
lazily; the function is broadcast once per distinct closure, byte-identical
consecutive maps skip the re-send, and jobs carry only their items);
results return in input order, and the first worker error is re-raised in
the parent.  A worker imports this package and torch, never JAX.

Each worker is configured before its first job:

* ``platform``: the torch device every job of the worker runs on, passed
  to the job as ``fn(item, device)``.  The default ``"cuda"`` puts a
  worker's jobs on the card, as every entry point of the port does;
  ``"cpu"`` keeps fold jobs on host cores in OS-process isolation (the
  reference's CPU worker model), ``"cuda:1"`` on another card.
* ``worker_env``: optional per-worker environment overrides for the
  child's spawn (e.g. ``CUDA_VISIBLE_DEVICES`` to give each worker its own
  card on a multi-card host), applied before the child imports torch.

The JAX package's ``distributed=`` (per-worker ``jax.distributed``
initialisation) has no counterpart: it belongs to JAX's multi-host
runtime.  ProcessFarm workers are local processes; farming across hosts
runs one farm per host.
"""

from __future__ import annotations

import atexit
import os
import pickle
import subprocess
import sys
import traceback
from dataclasses import dataclass, field
from multiprocessing.connection import Connection, Listener, wait
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["ProcessFarm"]


def _worker_entry(address: str, authkey_hex: str) -> None:
    """Worker main: connect back to the parent, receive the config, then
    serve ("fn" | "job" | "stop") messages until told to stop."""
    from multiprocessing.connection import Client

    conn = Client(address, authkey=bytes.fromhex(authkey_hex))
    cfg = conn.recv()

    import torch

    device = torch.device(cfg["platform"])
    import mpstime_tpu_torch  # noqa: F401  (the jobs' package, loaded once)
    cloudpickle = _require_cloudpickle()

    conn.send(("ready",))
    fn: Optional[Callable] = None
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        kind = msg[0]
        if kind == "stop":
            return
        if kind == "fn":
            fn = cloudpickle.loads(msg[1])
            continue
        _, idx, item_b = msg
        try:
            result = fn(cloudpickle.loads(item_b), device)
            conn.send((idx, True, cloudpickle.dumps(result)))
        except BaseException as e:            # reported to the parent
            try:
                err_b = cloudpickle.dumps(e)
            except (pickle.PicklingError, TypeError, AttributeError,
                    ValueError):
                err_b = None            # the parent raises the traceback
            conn.send((idx, False, (err_b, traceback.format_exc())))


def _require_cloudpickle():
    try:
        import cloudpickle
        return cloudpickle
    except ImportError as e:
        raise ImportError("ProcessFarm ships jobs with the cloudpickle "
                          "package, which is not installed") from e


@dataclass
class _Worker:
    wid: int
    proc: subprocess.Popen
    conn: Connection


@dataclass
class ProcessFarm:
    """A pool of subprocess workers with a DeviceFarm-compatible ``map``
    (order-preserving, first-error-wins) — pass it as the ``devices=``
    argument of :func:`tune` / :func:`evaluate` to farm fold jobs across
    OS processes instead of local devices (string spellings
    ``devices="processes"`` / ``"processes:N"`` construct one implicitly).

    Workers spawn lazily on the first ``map`` and persist across calls
    (CachingPool semantics); ``close()`` (or interpreter exit) stops them.
    """

    n_workers: int = 0                    # 0 -> min(4, cpu_count)
    platform: str = "cuda"                # the device each worker's jobs get
    worker_env: Optional[Sequence[Dict[str, str]]] = None
    _workers: List[_Worker] = field(default_factory=list, repr=False)
    _listener: Any = field(default=None, repr=False)
    _last_fn_sha: Optional[str] = field(default=None, repr=False)

    def __post_init__(self):
        if self.n_workers <= 0:
            # infer the worker count from worker_env when given
            self.n_workers = len(self.worker_env) if self.worker_env \
                else min(4, os.cpu_count() or 1)
        if self.worker_env is not None and \
                len(self.worker_env) < self.n_workers:
            raise ValueError(
                f"ProcessFarm(worker_env=...) has {len(self.worker_env)} "
                f"entries for {self.n_workers} workers — provide one per "
                "worker")

    # -- DeviceFarm-compatible surface -------------------------------------
    @property
    def devices(self) -> List[str]:
        """Placeholder identifiers (len() drives fold-vs-trial farming
        decisions exactly as a device list does)."""
        return [f"process:{i}" for i in range(self.n_workers)]

    def _ensure_workers(self) -> None:
        if self._workers:
            return
        _require_cloudpickle()
        authkey = os.urandom(16)
        self._listener = Listener(family="AF_UNIX", authkey=authkey)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        for i in range(self.n_workers):
            env = dict(os.environ)
            # the package must be importable in the bare child interpreter
            pp = env.get("PYTHONPATH", "")
            if repo_root not in pp.split(os.pathsep):
                env["PYTHONPATH"] = (repo_root + os.pathsep + pp).rstrip(
                    os.pathsep)
            env.update((self.worker_env[i] if self.worker_env else None)
                       or {})
            code = ("from mpstime_tpu_torch.parallel.procfarm import "
                    f"_worker_entry; _worker_entry({self._listener.address!r},"
                    f" {authkey.hex()!r})")
            proc = subprocess.Popen([sys.executable, "-c", code], env=env)
            conn = self._accept_from(proc, i)
            conn.send(dict(platform=self.platform))
            self._workers.append(_Worker(i, proc, conn))
        # workers import torch concurrently; wait for all of them
        for w in self._workers:
            msg = w.conn.recv()
            assert msg == ("ready",), msg
        atexit.register(self.close)

    def _accept_from(self, proc: subprocess.Popen, wid: int,
                     timeout_s: float = 120.0) -> Connection:
        """accept() that notices a worker dying before it connects (e.g. an
        import failure in the child) instead of blocking forever.  The
        blocking accept runs in a helper thread polled against the child's
        liveness — no reliance on multiprocessing.connection internals."""
        import queue
        import threading

        out: "queue.Queue" = queue.Queue(maxsize=1)

        def _accept():
            try:
                out.put(("ok", self._listener.accept()))
            except BaseException as e:              # noqa: BLE001
                out.put(("err", e))                 # listener closed/torn

        th = threading.Thread(target=_accept, daemon=True)
        th.start()
        deadline = timeout_s
        while True:
            try:
                kind, val = out.get(timeout=1.0)
            except queue.Empty:
                deadline -= 1.0
                if proc.poll() is not None:
                    self.close()    # closes the listener -> unblocks th
                    raise RuntimeError(
                        f"ProcessFarm worker {wid} exited with code "
                        f"{proc.returncode} before connecting (import "
                        "failure in the child environment?)")
                if deadline <= 0:
                    proc.kill()
                    self.close()
                    raise RuntimeError(
                        f"ProcessFarm worker {wid} did not connect "
                        f"within {timeout_s:.0f}s")
                continue
            if kind == "ok":
                return val
            raise val

    def map(self, fn: Callable[[Any, Any], Any], items) -> List[Any]:
        """Run ``fn(item, device)`` over ``items`` across the worker pool,
        ``device`` the worker's ``platform``.  ``fn`` and the items ship via
        cloudpickle (closures over arrays are fine); ``fn`` is broadcast
        once per call.  Results keep input order; the first
        worker exception is re-raised here (original object when it
        unpickles, else a RuntimeError carrying the worker traceback)."""
        cloudpickle = _require_cloudpickle()
        items = list(items)
        if not items:
            return []
        self._ensure_workers()
        fn_b = cloudpickle.dumps(fn)
        import hashlib
        fn_sha = hashlib.sha1(fn_b).hexdigest()
        if fn_sha != self._last_fn_sha:
            # skip the re-broadcast when consecutive maps ship byte-identical
            # closures (workers keep the last fn).  Invalidate BEFORE the
            # send loop: an interrupted broadcast must not leave a stale sha
            # claiming all workers hold the new fn.
            self._last_fn_sha = None
            for w in self._workers:
                w.conn.send(("fn", fn_b))
            self._last_fn_sha = fn_sha

        results: List[Any] = [None] * len(items)
        pending = list(enumerate(items))[::-1]
        idle = list(self._workers)
        busy: Dict[Connection, _Worker] = {}
        error: Optional[BaseException] = None
        while (pending and error is None) or busy:
            while pending and idle and error is None:
                i, it = pending.pop()
                w = idle.pop()
                w.conn.send(("job", i, cloudpickle.dumps(it)))
                busy[w.conn] = w
            if not busy:
                break
            ready = wait(list(busy), timeout=5)
            if not ready:
                dead = [w.wid for w in busy.values()
                        if w.proc.poll() is not None]
                if dead:
                    self.close()
                    raise RuntimeError(
                        f"ProcessFarm worker(s) {dead} died without "
                        "reporting a result")
                continue
            for conn in ready:
                w = busy.pop(conn)
                try:
                    idx, ok, payload = conn.recv()
                except (EOFError, OSError):
                    self.close()
                    raise RuntimeError(f"ProcessFarm worker {w.wid} "
                                       "disconnected mid-job")
                idle.append(w)
                if ok:
                    results[idx] = cloudpickle.loads(payload)
                elif error is None:
                    err_b, tb = payload
                    if err_b is not None:
                        try:
                            error = cloudpickle.loads(err_b)
                        except (pickle.UnpicklingError, AttributeError,
                                ImportError, TypeError, ValueError):
                            error = None
                    if error is None:
                        error = RuntimeError(
                            f"ProcessFarm worker {w.wid} failed:\n{tb}")
        if error is not None:
            raise error
        return results

    def close(self) -> None:
        """Stop all workers (idempotent)."""
        for w in self._workers:
            try:
                w.conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        for w in self._workers:
            try:
                w.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                w.proc.terminate()
                try:
                    w.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    w.proc.kill()
            w.conn.close()
        self._workers = []
        self._last_fn_sha = None
        if self._listener is not None:
            self._listener.close()
            self._listener = None

    def __enter__(self) -> "ProcessFarm":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
