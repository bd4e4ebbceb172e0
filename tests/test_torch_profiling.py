"""The port's tracing hooks (mpstime_tpu_torch/utils/profiling.py): a
Chrome / Perfetto trace of a fit, with the sweep's two ranges under the
JAX package's scope names."""

import json
import os

import numpy as np
import torch

import mpstime_tpu_torch as mt
from mpstime_tpu_torch.utils.profiling import TRACE_FILE, annotate, profile_trace

torch.set_num_threads(1)


def _events(logdir):
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def _spans(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == name]


def test_profile_trace_of_a_fit_holds_both_scopes(tmp_path, ecg200):
    Xtr, ytr, _, _ = ecg200
    logdir = str(tmp_path / "trace")
    with profile_trace(logdir) as prof:
        mt.fit_mps(Xtr[:20, :12], ytr[:20],
                   opts=mt.MPSOptions(nsweeps=1, chi_max=6, d=3,
                                      verbosity=-1, log_level=-1),
                   device="cpu")
    assert os.listdir(logdir) == [TRACE_FILE]
    events = _events(logdir)
    back = _spans(events, "mps/backward_bond")
    fwd = _spans(events, "mps/forward_bond")
    assert len(back) == len(fwd) == 1          # one range a half-sweep
    assert back[0][1] <= fwd[0][0]             # the backward half goes first
    # the bond steps' operations run inside the ranges
    inside = [e for e in events if e.get("cat") == "cpu_op"
              and back[0][0] <= e["ts"] <= back[0][1]]
    assert any("eigh" in e["name"] for e in inside)
    names = {e.key for e in prof.key_averages()}
    assert {"mps/backward_bond", "mps/forward_bond"} <= names


def test_annotate_nests(tmp_path):
    logdir = str(tmp_path / "nested")
    with profile_trace(logdir):
        with annotate("outer"):
            x = torch.ones(64, 64)
            with annotate("inner"):
                x = x @ x
            x = x + 1
    assert float(x[0, 0]) == 65.0
    events = _events(logdir)
    (o0, o1), = _spans(events, "outer")
    (i0, i1), = _spans(events, "inner")
    assert o0 <= i0 <= i1 <= o1


def test_scopes_leave_a_fit_unchanged(ecg200):
    """Without a profiler the ranges are inert: a fit gives the same bits
    with and without an enclosing annotate."""
    Xtr, ytr, _, _ = ecg200
    opts = mt.MPSOptions(nsweeps=1, chi_max=6, d=3, verbosity=-1,
                         log_level=-1)
    a, _, _ = mt.fit_mps(Xtr[:20, :12], ytr[:20], opts=opts, device="cpu")
    with annotate("outside"):
        b, _, _ = mt.fit_mps(Xtr[:20, :12], ytr[:20], opts=opts,
                             device="cpu")
    assert torch.equal(a.mps.cores, b.mps.cores)
    assert np.array_equal(a.mps.center.numpy(), b.mps.center.numpy())
