"""Profiling and tracing hooks (counterpart of
``mpstime_tpu/utils/profiling.py``; the reference has only coarse
wall-clock logging): the program's one span recorder and a trace writer.

Usage:

    from mpstime_tpu_torch.utils.profiling import profile_trace
    with profile_trace("/tmp/mps_trace"):
        fit_mps(X, y, opts=opts)

then open ``/tmp/mps_trace/trace.json`` in ui.perfetto.dev or
chrome://tracing.  The trace holds the host's operations, the card's
kernels and the program's spans, on one clock:

  ==========================  ==============================================
  ``mps/fit``                 a whole ``fit_mps`` call (a trace of its own)
  ``mps/fit/transform``       its ``transform_data``
  ``mps/fit/encode``          both ``encode_dataset`` calls, the cast to the
                              device included
  ``mps/fit/init``            ``random_mps`` and the training tensors; then
                              ``training.sweep._init_state`` (the left
                              environments and cold subspace caches)
  ``mps/backward_bond``,      each half-sweep's host issue time; these two
  ``mps/forward_bond``        are also ``record_function`` ranges, so on a
                              card they group the kernels they hold
  ``mps/launch``              a counted CUDA launch wrapper of
                              ``ops/bond_kernels.py`` / ``bond_kernels_c.py``
                              from entry to return (attribute ``kernel``)
  ``mps/polar``               inside a launch that ran Newton-Schulz power
                              steps: where their tails ran (attributes
                              ``path``, "block" or "team", and ``steps``;
                              ``bond_kernels.count_polar``)
  ``mps/classify``            a whole ``classify`` call (a trace of its own)
  ``mps/classify/encode``     transform, encoding and cast of the test set
  ``mps/classify/contract``   the contraction, argmax and readback, ending
                              when the labels are on the host
  ==========================  ==============================================

A span records only while a ``torch.profiler`` session is on (in the
benchmark's traced window, inside ``profile_trace``); otherwise
``annotate`` returns a shared context that does nothing, at the cost of
one check of the profiler's state.  Spans carry their name, start and end
in nanoseconds of Unix time (the clock kineto converts its host and CUPTI
timestamps to, so they line up with the trace's events), their thread,
their parent, and a trace id shared by every span of one ``fit_mps`` or
``classify`` call; parent and trace come from a stack of each thread's
own, so fits in ``DeviceFarm`` threads keep apart.  ``spans()`` reads the
recorded spans (at most ``MAX_SPANS``, the oldest dropped first),
``clear_spans()`` empties the buffer.  The program's spans are not
``record_function`` ranges (other than the two sweep ranges): kineto would
mirror each onto the card's timeline as an annotation.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple

import torch
from torch.profiler import ProfilerActivity

#: The trace file ``profile_trace`` writes into its ``logdir``.
TRACE_FILE = "trace.json"
#: The most spans the buffer keeps.
MAX_SPANS = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int                   # Unix time, ns
    end_ns: int
    span_id: int
    parent_id: int                  # 0: opened outside any span
    trace_id: int                   # the span_id of the trace's root
    thread: int                     # native thread id
    attrs: Dict[str, object]
    ranged: bool                    # also a record_function range


_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_spans_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()
_autograd_profiler = torch.autograd.profiler


def _tracing() -> bool:
    """Whether a torch.profiler session is on, in this thread or another
    (the profiler's own state is per thread; its global flag, where this
    PyTorch has one, covers the threads a session did not start in)."""
    return (getattr(_autograd_profiler, "_is_profiler_enabled", False)
            or torch.autograd._profiler_enabled())


class _Span:
    __slots__ = ("name", "attrs", "root", "ranged", "start", "ids")

    def __init__(self, name: str, attrs: dict, root: bool, ranged: bool):
        self.name, self.attrs, self.root, self.ranged = (name, attrs, root,
                                                         ranged)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        sid = next(_ids)
        parent, trace = stack[-1] if stack else (0, sid)
        self.ids = (sid, parent, sid if self.root else trace)
        stack.append((sid, self.ids[2]))
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        span = Span(self.name, self.start, end, *self.ids, _local.thread,
                    self.attrs, self.ranged)
        with _spans_lock:
            _spans.append(span)
        return False


def annotate(name: str, **attrs):
    """A span named ``name`` in the current thread's open trace (a trace of
    its own where none is open), with ``attrs``; a shared no-op context
    when no profiler session is on."""
    return _Span(name, attrs, False, False) if _tracing() else _OFF


def traced(name: str) -> Callable:
    """Decorator: each call of the function is the span ``name``, which
    starts a trace of its own (a whole ``fit_mps`` or ``classify``)."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _tracing():
                return fn(*args, **kw)
            with _Span(name, {}, True, False):
                return fn(*args, **kw)
        return call
    return wrap


@contextlib.contextmanager
def annotate_range(name: str) -> Iterator[None]:
    """A ``torch.profiler.record_function`` range that is also a program
    span while a profiler session is on (the sweep's two half-sweeps)."""
    with torch.profiler.record_function(name):
        if _tracing():
            with _Span(name, {}, False, True):
                yield
        else:
            yield


def spans() -> List[Span]:
    """The recorded spans, in the order they closed."""
    with _spans_lock:
        return list(_spans)


def clear_spans() -> None:
    with _spans_lock:
        _spans.clear()


def _trace_events(recorded: List[Span], base_ns: int) -> List[dict]:
    """Chrome trace complete events of ``recorded`` on the host threads that
    ran them; ``base_ns``: the trace's time origin (its ts are µs after
    it).  Spans that are record_function ranges are in the trace already."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "mps_span", "name": s.name, "pid": pid,
             "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                      "trace_id": s.trace_id, **s.attrs}}
            for s in recorded if not s.ranged]


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed block (the host's activity, the
    card's when CUDA is available, and the program's spans) into
    ``logdir/trace.json``, a Chrome / Perfetto trace.  Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sum the
    time by operation and kernel."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.time_ns()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # kineto writes ts in µs after baseTimeNanoseconds (older versions: in
    # µs of Unix time)
    doc["traceEvents"] += _trace_events(
        [s for s in spans() if s.start_ns >= t0],
        int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)
