"""Profiling and tracing hooks (counterpart of
``mpstime_tpu/utils/profiling.py``; the reference has only coarse
wall-clock logging).

Usage:

    from mpstime_tpu_torch.utils.profiling import profile_trace
    with profile_trace("/tmp/mps_trace"):
        fit_mps(X, y, opts=opts)

then open ``/tmp/mps_trace/trace.json`` in ui.perfetto.dev or
chrome://tracing.  Each sweep's half-sweeps run under the ranges
"mps/backward_bond" and "mps/forward_bond" (the JAX package's scope
names), so the kernels group by training phase; on a card the ranges
appear on the device's timeline too.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity

#: The trace file ``profile_trace`` writes into its ``logdir``.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed block (the host's activity, and the
    card's when CUDA is available) into ``logdir/trace.json``, a Chrome /
    Perfetto trace.  Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` sum the time by operation and kernel."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


annotate = torch.profiler.record_function
