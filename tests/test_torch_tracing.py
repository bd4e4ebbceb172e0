"""The program's span recorder (mpstime_tpu_torch/utils/profiling.py) and
the launch counters (ops/bond_kernels.py): the spans of a fit and a
classify under torch.profiler, their clock against the profiler's, and
counts that add up when threads launch at once."""

import json
import os
import statistics
import sys
import threading
from collections import Counter

import numpy as np
import torch

import mpstime_tpu_torch as mt
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.utils import profiling

torch.set_num_threads(1)

OPTS = mt.MPSOptions(nsweeps=2, chi_max=6, d=3, verbosity=-1, log_level=-1)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


def _fit(ecg200, opts=OPTS):
    Xtr, ytr, _, _ = ecg200
    return mt.fit_mps(Xtr[:20, :12], ytr[:20], opts=opts, device="cpu")[0]


def test_span_tree_of_a_fit_and_a_classify(ecg200):
    X_test = ecg200[2][:10, :12]
    profiling.clear_spans()
    _profiled(lambda: mt.classify(_fit(ecg200), X_test))
    spans = profiling.spans()
    fit, = [s for s in spans if s.name == "mps/fit"]
    cls, = [s for s in spans if s.name == "mps/classify"]
    # each call is a trace of its own, rooted at its span
    assert fit.trace_id == fit.span_id and cls.trace_id == cls.span_id
    assert fit.parent_id == cls.parent_id == 0
    assert {s.trace_id for s in spans} == {fit.trace_id, cls.trace_id}
    in_fit = Counter(s.name for s in spans if s.trace_id == fit.trace_id)
    assert in_fit == {"mps/fit": 1, "mps/fit/transform": 1,
                      "mps/fit/encode": 1, "mps/fit/init": 2,
                      "mps/backward_bond": OPTS.nsweeps,
                      "mps/forward_bond": OPTS.nsweeps}
    assert Counter(s.name for s in spans if s.trace_id == cls.trace_id) == {
        "mps/classify": 1, "mps/classify/encode": 1,
        "mps/classify/contract": 1}
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.span_id != s.trace_id:
            parent = by_id[s.parent_id]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    # every child of a call is a direct child, in the order it ran
    kids = [s for s in spans if s.parent_id == fit.span_id]
    assert len(kids) == sum(in_fit.values()) - 1
    assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)][:4] == [
        "mps/fit/transform", "mps/fit/encode", "mps/fit/init",
        "mps/fit/init"]
    halves = sorted((s for s in kids if s.ranged), key=lambda s: s.start_ns)
    assert [s.name for s in halves] == ["mps/backward_bond",
                                        "mps/forward_bond"] * OPTS.nsweeps
    assert all(a.end_ns <= b.start_ns for a, b in zip(halves, halves[1:]))
    assert {s.thread for s in spans} == {threading.get_native_id()}


def test_nothing_is_recorded_without_a_profiler(ecg200):
    profiling.clear_spans()
    trained = _fit(ecg200)
    mt.classify(trained, ecg200[2][:5, :12])
    with profiling.annotate("outside"):
        pass
    assert profiling.spans() == []
    assert profiling.annotate("a") is profiling.annotate("b")


def test_a_fit_is_the_same_with_the_profiler_on_and_off(ecg200):
    opts = OPTS.replace(dtype=np.float32)
    a = _fit(ecg200, opts)
    b = _profiled(lambda: _fit(ecg200, opts))
    assert torch.equal(a.mps.cores, b.mps.cores)
    assert torch.equal(a.mps.center, b.mps.center)


def test_fits_in_two_threads_keep_their_traces_apart(ecg200):
    profiling.clear_spans()
    start = threading.Barrier(2)
    out = {}

    def work(i):
        start.wait(timeout=60)
        _fit(ecg200)
        out[i] = threading.get_native_id()

    def both():
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)

    _profiled(both)
    spans = profiling.spans()
    roots = [s for s in spans if s.name == "mps/fit"]
    assert len(roots) == 2 and len({r.trace_id for r in roots}) == 2
    for r in roots:
        mine = [s for s in spans if s.trace_id == r.trace_id]
        assert {s.thread for s in mine} == {r.thread}
        assert sum(s.name == "mps/backward_bond" for s in mine) \
            == OPTS.nsweeps
    assert {r.thread for r in roots} == set(out.values())


def test_spans_share_the_profilers_clock(tmp_path):
    """A program span opened directly around a record_function range starts
    and ends within 50 us of it in profile_trace's trace.json."""
    logdir = str(tmp_path / "clock")
    pairs = 9
    with profiling.profile_trace(logdir):
        with torch.profiler.record_function("warm-up"):
            torch.ones(8).sum()
        for i in range(pairs):
            with profiling.annotate(f"span/{i}"):
                with torch.profiler.record_function(f"range/{i}"):
                    torch.ones(8).sum()
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"}
    starts, ends = [], []
    for i in range(pairs):
        s, r = events[f"span/{i}"], events[f"range/{i}"]
        assert s["cat"] == "mps_span" and r["cat"] == "user_annotation"
        assert s["tid"] == r["tid"]
        starts.append(abs(r["ts"] - s["ts"]))
        ends.append(abs((s["ts"] + s["dur"]) - (r["ts"] + r["dur"])))
    # the median keeps a pair the scheduler interrupted from deciding
    assert statistics.median(starts) < 50.0, starts
    assert statistics.median(ends) < 50.0, ends


def test_profile_trace_holds_each_program_span_once(tmp_path, ecg200):
    logdir = str(tmp_path / "fit")
    with profiling.profile_trace(logdir):
        _fit(ecg200)
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    named = Counter((e["cat"], e["name"]) for e in events
                    if e["name"].startswith("mps/"))
    assert named[("mps_span", "mps/fit")] == 1
    assert named[("mps_span", "mps/fit/init")] == 2
    # the sweep's ranges are in the trace once, as the profiler's ranges
    assert named[("user_annotation", "mps/backward_bond")] == OPTS.nsweeps
    assert not [k for k in named if k[0] == "mps_span" and "bond" in k[1]]


def test_counts_from_threads_add_up():
    """Threads that dispatch to the plain versions and launch at once lose
    no count (a forced switch every microsecond)."""
    real, cplx = torch.zeros(1), torch.zeros(1, dtype=torch.complex64)
    launch = bk.counted_launch("k12")(lambda: None)
    n_threads, n = 8, 2000
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=60)
        for _ in range(n):
            bk._piece("k1a", real)
            bk._piece("k2_env", cplx, calls=2)
            launch()

    bk.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1a": total, "k2c_env": 2 * total}
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {"k12": total}
    bk.reset_counts()
    assert not any(bk.LAUNCHES.values()) and not any(bk.PLAIN_CALLS.values())


def test_a_counted_launch_is_a_span_under_the_profiler():
    calls = []
    launch = bk.counted_launch("k2c")(lambda x: calls.append(x) or x + 1)
    profiling.clear_spans()
    bk.reset_counts()
    assert _profiled(lambda: launch(1)) == 2
    assert launch(2) == 3
    assert calls == [1, 2] and bk.LAUNCHES["k2c"] == 2
    s, = profiling.spans()
    assert (s.name, s.attrs) == ("mps/launch", {"kernel": "k2c"})
    bk.reset_counts()


def test_a_launch_that_runs_power_steps_holds_a_polar_span():
    launch = bk.counted_launch("k12m")(
        lambda chi, d, steps: bk.count_polar(chi, d, steps))
    profiling.clear_spans()
    bk.reset_counts()
    _profiled(lambda: (launch(25, 5, 8), launch(40, 15, 8),
                       launch(40, 15, 0)))
    launch(40, 15, 3)                     # unprofiled: counted, no span
    assert bk.POLAR_STEPS == {"block": 8, "team": 11}
    spans = profiling.spans()
    launches = {s.span_id: s for s in spans if s.name == "mps/launch"}
    polar = [s for s in spans if s.name == "mps/polar"]
    assert len(launches) == 3
    assert [s.attrs for s in polar] == [{"path": "block", "steps": 8},
                                        {"path": "team", "steps": 8}]
    for s in polar:
        parent = launches[s.parent_id]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    bk.reset_counts()
