"""The program's own spans (mpstime_tpu_torch.utils.profiling) in a traced
run: each traced fit_mps and classify call is a trace of spans rooted at
"mps/fit" or "mps/classify".  A reader takes the last len(run.traced)
traces of its root, so that runs in one process do not mix, and reads
nothing (None) where the program records no spans."""

from __future__ import annotations

from typing import List, Optional

FIT, CLASSIFY = "mps/fit", "mps/classify"


def traces(run, root: str) -> Optional[List[list]]:
    """The spans of each of the run's last traces rooted at ``root``, oldest
    first; None where there are none."""
    if not run.traced:
        return None
    from mpstime_tpu_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = read()
    roots = sorted((s for s in spans if s.name == root
                    and s.span_id == s.trace_id),
                   key=lambda s: s.start_ns)[-len(run.traced):]
    if not roots:
        return None
    by_trace = {r.trace_id: [] for r in roots}
    for s in spans:
        if s.trace_id in by_trace:
            by_trace[s.trace_id].append(s)
    return list(by_trace.values())


def seconds(spans, *names: str) -> float:
    """Total seconds of the spans named ``names``."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e9


def mean_ms(run, root: str, *names: str) -> Optional[float]:
    """ms of the spans ``names`` per trace rooted at ``root``."""
    tr = traces(run, root)
    if tr is None:
        return None
    return 1e3 * sum(seconds(t, *names) for t in tr) / len(tr)
