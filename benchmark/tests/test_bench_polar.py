"""The reader of the program's mps/polar spans (team_polar_steps), on spans
recorded on the CPU; the case marked ``cuda`` reads it in every cell on
the card at its full size."""

import json
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent
sys.path[:0] = [str(HERE), str(REPO)]

import harness                                    # noqa: E402

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _traced_fits(polar_calls, sweeps=2):
    """Two fits under a profiler, each a trace rooted at mps/fit whose
    counted launches run ``polar_calls``, count_polar's arguments (chi, d,
    steps, is_complex); their records as a traced run holds them."""
    import torch
    from mpstime_tpu_torch.ops import bond_kernels as bk
    from mpstime_tpu_torch.utils import profiling

    launch = bk.counted_launch("k12m")(
        lambda chi, d, steps, cplx: bk.count_polar(chi, d, steps, cplx))

    @profiling.traced("mps/fit")
    def fit():
        for call in polar_calls:
            launch(*call)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fit()
        fit()
    bk.reset_counts()
    return [harness.FitRecord(i, 0, 0.0, 1.0, 0.1, [0.5] * sweeps,
                              profiled=True) for i in range(2)]


def _run(fits):
    return harness.Run("legendre_d15_chi40.fit.ecg200", {}, 1.0, fits)


def test_team_steps_are_counted_by_path_per_sweep():
    read = harness.reader("team_polar_steps")
    # per fit: 3 leader steps (chi 25 d 5), 2 + 5 team steps (chi 40 d 15,
    # real; chi 25 complex), a launch with no power step
    fits = _traced_fits([(25, 5, 3, False), (40, 15, 2, False),
                         (25, 5, 5, True), (40, 15, 0, False)])
    assert read(_run(fits)) == 7 / 2
    # every tail on the leader block reads 0, not nothing
    assert read(_run(_traced_fits([(25, 5, 4, False)], sweeps=4))) == 0
    # traced fits that ran no power step on the card read nothing
    assert read(_run(_traced_fits([(40, 15, 0, False)]))) is None


def test_team_steps_read_nothing_of_an_untraced_run(monkeypatch):
    from mpstime_tpu_torch.utils import profiling
    read = harness.reader("team_polar_steps")
    fits = _traced_fits([(40, 15, 2, False)])
    assert read(_run(fits)) == 1.0
    for f in fits:
        f.profiled = False
    assert read(_run(fits)) is None
    # a program that records no spans reads as nothing, not as an error
    monkeypatch.delattr(profiling, "spans")
    for f in fits:
        f.profiled = True
    assert read(_run(fits)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_team_steps_in_each_cell_on_the_card(workload):
    """Every power step's tail of a cell's traced sweeps on one path:
    2 (T - 1) q "team" steps a sweep where polar_path says "team" (the
    complex cells and d 15 chi 40), 0 where the leader block takes them."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpstime_tpu_torch.ops import bond_kernels as bk
    cell = harness.find_cell(workload)
    res = harness.run_cell(cell, 2 ** 31 + 23, 1.0, True,
                           time.perf_counter(), log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    o = cell.config["options"]
    team = bk.polar_path(o["chi_max"], o["d"],
                         o["dtype"].startswith("complex")) == "team"
    T = cell.traffic["shape"]["T"]
    want = 2 * (T - 1) * o["subspace_power_iters"] if team else 0
    assert res["metrics"]["team_polar_steps"]["value"] == want
