"""Reduce a torch.profiler run over a few fits to what the per-layer
readers need: the device's busy time, the kernels inside the sweep's
ranges, the device operations that took most time, and the idle gaps by
what the host was doing (the benchmark's own spans and the sweep's
ranges)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: The sweep's record_function ranges (training/sweep.py).  torch.profiler
#: also lists them among the device events, as spans over the kernels they
#: hold, so device-time sums leave them out.
SCOPES = ("mps/backward_bond", "mps/forward_bond")
#: The benchmark's own host spans around each call of the window.
SPAN_FIT, SPAN_CLASSIFY, SPAN_WINDOW = ("bench/fit_mps", "bench/classify",
                                        "bench/traced_window")
ANNOTATIONS = frozenset(SCOPES + (SPAN_FIT, SPAN_CLASSIFY, SPAN_WINDOW))
#: Kernel names in the breakdown are cut to this length (PyTorch's
#: templated kernels run to hundreds of characters).
NAME_CHARS = 120


@dataclass
class TraceSummary:
    window_s: float = 0.0                # the traced window (host span)
    busy_s: float = 0.0                  # union of device operations
    range_kernel_s: float = 0.0          # device time inside the ranges
    range_kernels: int = 0               # device operations inside them
    device_ops: List[Tuple[str, float]] = field(default_factory=list)  # s
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def device_ms(prof) -> Dict[str, float]:
    """Device ms by kernel of a torch.profiler run (each event's own time),
    the sweep's ranges left out."""
    from torch.autograd import DeviceType
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in ANNOTATIONS}


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(mid: float, host: Dict[str, list]) -> str:
    """What the host was doing at time ``mid``: in a sweep's range, in the
    rest of fit_mps (before its first sweep: prep; after it: between or
    after the sweeps), in classify, or in the benchmark's loop."""
    def inside(name):
        return next(((s, e) for s, e in host.get(name, ())
                     if s <= mid < e), None)
    if inside(SCOPES[0]) or inside(SCOPES[1]):
        return "sweep"
    fit = inside(SPAN_FIT)
    if fit:
        first = min((s for name in SCOPES for s, _ in host.get(name, ())
                     if fit[0] <= s < fit[1]), default=fit[1])
        return "fit prep" if mid < first else "fit between or after sweeps"
    if inside(SPAN_CLASSIFY):
        return "classify"
    return "benchmark loop"


def reduce_events(events) -> TraceSummary:
    """Reduce (name, is_device, is_annotation, start_us, end_us) tuples."""
    kernels, ranges, host = [], [], defaultdict(list)
    for name, on_device, annotation, s, e in events:
        if on_device:
            if annotation or name in ANNOTATIONS:
                if name in SCOPES:
                    ranges.append((s, e))
            else:
                kernels.append((s, e, name))
        elif name in ANNOTATIONS:
            host[name].append((s, e))
    out = TraceSummary()
    win = host.get(SPAN_WINDOW)
    if not win or not kernels:
        return out
    w0, w1 = win[0]
    out.window_s = (w1 - w0) / 1e6
    busy = _merge([(s, e) for s, e, _ in kernels])
    out.busy_s = sum(e - s for s, e in busy) / 1e6
    rng = _merge(ranges)
    starts = [s for s, _ in rng]
    for s, e, name in kernels:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= rng[i][1]:
            out.range_kernel_s += (e - s) / 1e6
            out.range_kernels += 1
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        a, b = max(a, w0), min(b, w1)
        if b > a:
            gaps[_label((a + b) / 2, host)] += (b - a) / 1e6
    out.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return out


def reduce_profile(prof) -> TraceSummary:
    """A TraceSummary of a torch.profiler run that wrapped the traced fits
    in the span ``bench/traced_window``."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        rows.append((e.name, on_device,
                     bool(getattr(e, "is_user_annotation", False)),
                     e.time_range.start, e.time_range.end))
    out = reduce_events(rows)
    top = sorted(device_ms(prof).items(), key=lambda kv: -kv[1])[:10]
    out.device_ops = [(name[:NAME_CHARS], ms / 1e3) for name, ms in top]
    return out
