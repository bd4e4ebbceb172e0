"""CPU tests of the benchmark harness (run from the repository's root:
``python -m pytest benchmark/tests -q``).  Cases that need the card are
marked ``cuda`` and decide inside the test whether there is one."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent
sys.path[:0] = [str(HERE), str(REPO)]

import devtrace                                   # noqa: E402
import harness                                    # noqa: E402
import work                                       # noqa: E402

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
#: A cut that a CPU test holds: 40 training series, 20 test, 24 sites,
#: 4 sweeps (so sweeps 0-1 are early, 2 drawn and 3 the last).
CUT = dict(n_train=40, n_test=20, T=24, nsweeps=4)


@pytest.mark.parametrize("workload", CELLS)
def test_cells_found_by_name(workload):
    cell = harness.find_cell(workload)
    import mpstime_tpu_torch as mt
    mt.MPSOptions(**cell.config["options"])
    assert cell.config["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == workload)
    # every number but block_gap is compared in every cell; block_gap
    # wherever the route runs fused blocks of steps (the real route)
    import control
    want = set(harness.check.NUMBERS) - {"block_gap"}
    if control.can_have(cell, "first_step_only"):
        want.add("block_gap")
    assert set(cell.limits) == want
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"setup_s", "train_samples_per_s"} <= names


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_frozen_counts_reproduce_the_kernel_bounds():
    """The bounds of PERF.md's kernel table (C 2, chi 25, d 5, N 100)."""
    ms = lambda w: round(work.bound(w)[0], 6)            # noqa: E731
    assert ms(work.k12_work(2, 25, 5, 100)) == 0.000364
    assert ms(work.k12_work(2, 25, 5, 100, Bb=8)) == 0.002912
    assert ms(work.k12_work(2, 25, 5, 100, q=3, cplx=True)) == 0.002384


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": f"{HERE}:{REPO}"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    mods = _modules_after("import harness, control, check\n"
                          "import reference.plain\n"
                          "import mpstime_tpu_torch")
    assert not mods & {"jax", "jaxlib", "flax", "mpstime_tpu"}
    assert "mpstime_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import check, reference.plain")
    assert not mods & {"mpstime_tpu_torch", "mpstime_tpu", "jax"}


def test_run_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_cpu_path(workload):
    """A whole run at a tiny cut on the CPU (the kernels' plain versions):
    every number within the cell's limits, and the result line's keys."""
    import time
    res = harness.run_cell(harness.find_cell(workload), 2 ** 31 + 12345,
                           0.5, False, time.perf_counter(), device="cpu",
                           cut=CUT, log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"train_samples_per_s", "setup_s"} <= set(res["metrics"])
    assert res["checks"]["start_gap"]["value"] < 1e-6


def test_trace_reduction():
    """Busy time is the union of device operations; kernels inside the
    ranges count toward the range time; gaps take the host's span."""
    ev = [("bench/traced_window", False, False, 0, 100),
          ("bench/fit_mps", False, False, 0, 80),
          ("mps/backward_bond", False, False, 10, 40),
          ("mps/backward_bond", True, True, 12, 45),
          ("k12m", True, False, 12, 30), ("k12m", True, False, 25, 45),
          ("copy", True, False, 60, 70),
          ("bench/classify", False, False, 80, 100),
          ("gemm", True, False, 85, 90)]
    s = devtrace.reduce_events(ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((33 + 10 + 5) * 1e-6)
    assert s.range_kernels == 2
    assert s.range_kernel_s == pytest.approx(38e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["fit prep"] == pytest.approx(12e-6)
    # gaps are labelled by their midpoint: 45-60 and 70-85 in fit_mps
    assert gaps["fit between or after sweeps"] == pytest.approx(30e-6)
    assert gaps["classify"] == pytest.approx(10e-6)


def test_readers_on_a_run():
    fits = [harness.FitRecord(i, i, 10.0 * i, 9.0, 1.0, [0.5] * 10,
                              profiled=i == 0) for i in range(3)]
    tr = devtrace.TraceSummary(window_s=10.0, busy_s=6.0,
                               range_kernel_s=4.0, range_kernels=500)
    shape = dict(N=100, T=96, C=2, chi=25, d=5, q=1, cplx=False)
    run = harness.Run("x", shape, 12.0, fits, tr)
    read = {m: harness.reader(m)(run) for m in (
        "train_samples_per_s", "sweep_ms_p95", "fit_prep_ms", "classify_ms",
        "launches_per_sweep", "device_idle_pct", "bond_roofline_pct",
        "fit_mfu", "setup_s")}
    assert read["train_samples_per_s"] == pytest.approx(100 * 30 / 30.0)
    assert read["sweep_ms_p95"] == pytest.approx(500.0)
    assert read["fit_prep_ms"] == pytest.approx(4000.0)
    assert read["classify_ms"] == pytest.approx(1000.0)
    assert read["launches_per_sweep"] == pytest.approx(50.0)
    assert read["device_idle_pct"] == pytest.approx(40.0)
    least = 10 * 190 * work.bound(work.k12_work(2, 25, 5, 100))[0] / 1e3
    assert read["bond_roofline_pct"] == pytest.approx(100 * least / 4.0)
    assert read["setup_s"] == 12.0
    assert 0 < read["fit_mfu"] < 100
    assert harness.reader("fit_mfu")(harness.Run("x", shape, 1.0, fits)) \
        is None


def test_traffic_is_fixed_by_the_seed():
    cell = harness.find_cell("legendre.fit.wafer")
    a = harness.generator.make_data(cell.traffic, 2 ** 31 + 7)
    b = harness.generator.make_data(cell.traffic, 2 ** 31 + 7)
    c = harness.generator.make_data(cell.traffic, 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [x.shape for x in a] == [x.shape for x in c]
    assert a[0].shape == (1000, 152) and a[2].shape == (6164, 152)
    assert not np.array_equal(a[0], c[0])
