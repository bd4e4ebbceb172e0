"""The readers of the program's spans (benchmark/program_spans.py and the
six metrics that read it), run on a cut cell on the CPU; the case marked
``cuda`` runs the cell on the card at its full size."""

import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness                                    # noqa: E402
import program_spans                              # noqa: E402

#: The six metrics of the program's spans.
SPAN_METRICS = ("fit_encode_ms", "fit_init_ms", "sweep_issue_ms",
                "launch_host_us", "classify_encode_ms",
                "classify_contract_ms")
CUT = dict(n_train=40, n_test=20, T=24, nsweeps=3)


def _run(workload, seed, trace, cut=CUT, device="cpu", seconds=0.3):
    return harness.run_cell(harness.find_cell(workload), seed, seconds,
                            trace, time.perf_counter(), device=device,
                            cut=cut, log=lambda *a, **k: None)


def _expected(spans):
    """The six numbers worked out from ``spans``, one run's alone."""
    def traces(root):
        ids = {s.trace_id for s in spans if s.name == root
               and s.span_id == s.trace_id}
        return [[s for s in spans if s.trace_id == i] for i in ids]

    def per(root, *names):
        tr = traces(root)
        return 1e3 * sum(program_spans.seconds(t, *names)
                         for t in tr) / len(tr)
    fit = traces(program_spans.FIT)
    sweeps = sum(s.name == "mps/backward_bond" for t in fit for s in t)
    return {"fit_encode_ms": per("mps/fit", "mps/fit/transform",
                                 "mps/fit/encode"),
            "fit_init_ms": per("mps/fit", "mps/fit/init"),
            "sweep_issue_ms": 1e3 * sum(
                program_spans.seconds(t, "mps/backward_bond",
                                      "mps/forward_bond")
                for t in fit) / sweeps,
            "classify_encode_ms": per("mps/classify",
                                      "mps/classify/encode"),
            "classify_contract_ms": per("mps/classify",
                                        "mps/classify/contract")}


def test_two_traced_runs_in_one_process_read_their_own_fits():
    from mpstime_tpu_torch.utils import profiling
    profiling.clear_spans()
    first = _run("legendre.fit.ecg200", 2 ** 31 + 99, True,
                 cut=dict(CUT, nsweeps=2, T=16))
    t1 = time.time_ns()
    second = _run("fourier.fit.ecg200", 2 ** 31 + 7, True)
    for res in (first, second):
        assert res["correct"], res["checks"]
        got = {m: res["metrics"][m]["value"] for m in SPAN_METRICS
               if m in res["metrics"]}
        # no launch on the CPU: the kernels' plain versions run there
        assert set(got) == set(SPAN_METRICS) - {"launch_host_us"}
        assert all(v > 0 for v in got.values()), got
    spans = profiling.spans()
    mine = [s for s in spans if s.start_ns >= t1]
    assert len(mine) < len(spans)               # the first run's are there
    want = _expected(mine)
    got = {m: second["metrics"][m]["value"] for m in want}
    assert got == pytest.approx(want, rel=1e-12)
    # the traced fits (3 on ECG200), each with its classify
    assert sum(s.name == "mps/fit" for s in mine) == 3
    assert sum(s.name == "mps/classify" for s in mine) == 3


def test_the_readers_read_nothing_of_an_untraced_run(monkeypatch):
    from mpstime_tpu_torch.utils import profiling
    import torch
    import mpstime_tpu_torch as mt
    import numpy as np
    # spans of an earlier traced fit stay in the buffer
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        mt.fit_mps(np.random.default_rng(0).normal(size=(8, 6)),
                   np.arange(8) % 2, opts=mt.MPSOptions(
                       nsweeps=1, chi_max=4, d=3, verbosity=-1,
                       log_level=-1), device="cpu")
    assert any(s.name == "mps/fit" for s in profiling.spans())
    fits = [harness.FitRecord(0, 0, 0.0, 1.0, 0.1, [0.5], profiled=False)]
    run = harness.Run("legendre.fit.ecg200", {}, 1.0, fits)
    for m in SPAN_METRICS:
        assert harness.reader(m)(run) is None
    # a program that records no spans (the parent of this benchmark's
    # readers) reads as nothing, not as an error
    monkeypatch.delattr(profiling, "spans")
    run.fits[0].profiled = True
    for m in SPAN_METRICS:
        assert harness.reader(m)(run) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["legendre.fit.ecg200",
                                      "fourier.fit.ecg200"])
def test_the_six_readers_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = _run(workload, 2 ** 31 + 5, True, cut=None, device="cuda",
               seconds=1.0)
    assert res["correct"], res["checks"]
    got = {m: res["metrics"][m]["value"] for m in SPAN_METRICS}
    assert all(v > 0 for v in got.values()), got
    # the program's spans never reach the card's timeline
    ops = [name for name, _ in res["breakdown"]["device_ops"]]
    assert not [n for n in ops if n.startswith("mps/")], ops
