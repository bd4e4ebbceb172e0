"""The comparison that decides ``correct`` has to fail what it should: the
control (the reference in bfloat16 in the program's place) and each fault
the cells can have, planted in the program underneath a run.  At a cut the
CPU holds; the card-sized readings come from ``benchmark/control.py``."""

import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import check                                      # noqa: E402
import control                                    # noqa: E402
import harness                                    # noqa: E402

CUT = dict(n_train=40, n_test=20, T=24, nsweeps=4)
CELLS = ["legendre.fit.ecg200", "fourier.fit.ecg200"]
ALL = [w for w in harness.json.loads(
    (HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


def _fails(numbers: dict, limits: dict) -> list:
    return [k for k in limits if numbers[k] > limits[k]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = harness.find_cell(workload)
    fit, opts, data = control.one_fit(cell, 2 ** 31 + 99, "cpu", CUT)
    sound = check.judge([fit], opts, data, "cpu")
    low = check.judge([fit], opts, data, "cpu", control=True)
    assert not _fails(sound, cell.limits), sound
    assert _fails(low, cell.limits), low


@pytest.mark.parametrize("workload,fault", [
    (w, f) for f in sorted(control.FAULTS) for w in CELLS
    if control.can_have(harness.find_cell(w), f)])
def test_faults_come_out_not_correct(workload, fault, monkeypatch):
    """A run with the program broken underneath reports correct false."""
    import mpstime_tpu_torch
    from mpstime_tpu_torch.training import sweep as sweep_mod
    if control.FAULTS[fault][0] == "classify":
        monkeypatch.setattr(mpstime_tpu_torch, "classify",
                            control.altered(mpstime_tpu_torch.classify))
    else:
        control.plant_faults(sweep_mod, fault, monkeypatch.setattr)
    res = harness.run_cell(harness.find_cell(workload), 777, 0.2, False,
                           time.perf_counter(), device="cpu", cut=CUT,
                           log=lambda *a, **k: None)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in ALL])
def test_control_on_the_card_at_the_cells_size(workload):
    """The control and the faults at the cell's own size, one seed."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = harness.find_cell(workload)
    fit, opts, data = control.one_fit(cell, 11)
    assert not _fails(check.judge([fit], opts, data, "cuda"), cell.limits)
    assert _fails(check.judge([fit], opts, data, "cuda", control=True),
                  cell.limits)
    for fault in (f for f in control.FAULTS if control.can_have(cell, f)):
        f, opts, data = control.one_fit(cell, 11, fault=fault)
        assert _fails(check.judge([f], opts, data, "cuda"), cell.limits)
