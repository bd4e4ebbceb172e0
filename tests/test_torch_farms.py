"""The port's fold farms (parallel/farm.py ``DeviceFarm``, parallel/
procfarm.py ``ProcessFarm``) held against the JAX package's contract on the
CPU: results in input order, the first error wins, each job handed its
device, the device-list partition of ``divide_devices``, worker processes
that import the port and never JAX, and tune / evaluate farmed over them
equal to the sequential runs."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mpstime_tpu as mj
import mpstime_tpu_torch as mt
from mpstime_tpu.parallel.farm import divide_devices as jax_divide
from mpstime_tpu_torch.parallel import (DeviceFarm, ProcessFarm,
                                        resolve_devices, resolve_process_farm)
from mpstime_tpu_torch.parallel.farm import divide_devices

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def farm2():
    """One 2-worker farm for the module (each worker imports torch)."""
    farm = ProcessFarm(2, platform="cpu")
    yield farm
    farm.close()


# ---- DeviceFarm ----------------------------------------------------------------

def test_device_farm_keeps_order_and_hands_each_job_its_device():
    farm = DeviceFarm(["cpu", "cpu"])
    assert farm.devices == [CPU, CPU]
    out = farm.map(lambda i, dev: (i * i, dev), range(7))
    assert [o[0] for o in out] == [i * i for i in range(7)]
    assert all(o[1] == CPU for o in out)
    assert DeviceFarm(["cpu"]).map(lambda i, dev: i + 1, [1, 2]) == [2, 3]
    assert farm.map(lambda i, dev: i, []) == []


def test_device_farm_first_error_wins():
    farm = DeviceFarm(["cpu", "cpu"])
    ran = []

    def job(i, dev):
        ran.append(i)
        if i == 1:
            raise ZeroDivisionError("job 1")
        return i

    with pytest.raises(ZeroDivisionError, match="job 1"):
        farm.map(job, range(50))
    assert len(ran) < 50            # the rest of the queue was cancelled
    assert farm.map(lambda i, dev: -i, range(3)) == [0, -1, -2]


def test_resolve_and_divide_devices():
    assert resolve_devices(None) is None and resolve_devices(False) is None
    assert resolve_devices("cpu") == [CPU]
    assert resolve_devices(["cpu", torch.device("cpu")]) == [CPU, CPU]
    assert resolve_devices([]) is None
    for devs, n in ((list(range(8)), 3), (list(range(2)), 5),
                    (["a", "b", "c"], 3), (list(range(5)), 0)):
        assert divide_devices(devs, n) == jax_divide(devs, n)


def test_resolve_process_farm_spellings():
    # an implicit farm's workers run on the caller's device, the card
    # unless the CPU is asked for
    farm = resolve_process_farm("processes:3")
    assert isinstance(farm, ProcessFarm) and farm.n_workers == 3
    assert farm.platform == "cuda" and ProcessFarm().platform == "cuda"
    assert resolve_process_farm("processes:2", "cpu").platform == "cpu"
    assert resolve_process_farm("processes", torch.device("cuda", 1)
                                ).platform == "cuda:1"
    assert resolve_process_farm("processes").n_workers >= 1
    assert resolve_process_farm(farm) is farm
    for other in ("all", None, ["cpu"], "cpu"):
        assert resolve_process_farm(other) is None
    with pytest.raises(ValueError, match="one per worker"):
        ProcessFarm(3, worker_env=[{}])


# ---- ProcessFarm -----------------------------------------------------------------

def test_process_farm_keeps_order_and_reuses_workers(farm2):
    base = np.arange(3.0)
    out = farm2.map(lambda i, dev: float((base * i).sum()), range(5))
    assert out == [0.0, 3.0, 6.0, 9.0, 12.0]
    assert farm2.map(lambda s, dev: s.upper(), ["a", "b"]) == ["A", "B"]
    pids = set(farm2.map(lambda _, dev: os.getpid(), range(4)))
    assert len(pids) == 2 and os.getpid() not in pids


def test_process_farm_workers_run_the_port_without_jax(farm2):
    out = farm2.map(lambda _, dev: (
        sorted(m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "mpstime_tpu."))
               and not m.startswith("mpstime_tpu_torch")),
        "mpstime_tpu_torch" in sys.modules, str(dev)), range(2))
    for bad, port, dev in out:
        assert bad == [] and port and dev == "cpu"


def test_process_farm_first_error_wins(farm2):
    with pytest.raises(ZeroDivisionError):
        farm2.map(lambda i, dev: 1 // 0 if i == 1 else i, range(3))
    assert farm2.map(lambda i, dev: i * i, range(4)) == [0, 1, 4, 9]


def test_process_farm_reusable_after_close():
    farm = ProcessFarm(1, platform="cpu")
    assert farm.map(lambda i, dev: i + 1, [1]) == [2]
    farm.close()
    assert farm.map(lambda i, dev: i + 2, [1]) == [3]
    farm.close()


def test_port_modules_import_no_jax():
    # a fresh interpreter: importing every new module of the port (and the
    # package) loads neither JAX nor the JAX package
    code = ("import sys, mpstime_tpu_torch, mpstime_tpu_torch.hyperopt, "
            "mpstime_tpu_torch.models.serialize, "
            "mpstime_tpu_torch.models.itensor_import, "
            "mpstime_tpu_torch.models.classifier, "
            "mpstime_tpu_torch.parallel; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'mpstime_tpu.')) or m == 'mpstime_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "import mpstime_tpu\n" not in src and "from mpstime_tpu." not in src


# ---- farmed tune and evaluate ---------------------------------------------------

def _tune_kw():
    return dict(nfolds=2, parameters={"chi_max": (4, 8), "d": [2, 3]},
                rng=3, maxiters=2, verbosity=0,
                objective=mt.MisclassificationRate(),
                opts0=mt.MPSOptions(nsweeps=1, verbosity=-5, log_level=-1,
                                    dtype="float64"))


@pytest.fixture(scope="module")
def sequential_tune(two_class_sines):
    Xs, ys = two_class_sines[0], two_class_sines[1]
    return mt.tune(Xs, ys, **_tune_kw(), device="cpu")


@pytest.mark.parametrize("devices", ["device-farm", "process-farm",
                                     "one-device"])
def test_farmed_tune_equals_sequential(two_class_sines, sequential_tune,
                                       farm2, devices):
    """Fold jobs on two threads or two worker processes give the
    sequential result exactly; a list of one device runs unfarmed there."""
    Xs, ys = two_class_sines[0], two_class_sines[1]
    farm = {"device-farm": ["cpu", "cpu"], "process-farm": farm2,
            "one-device": ["cpu"]}[devices]
    best, cache = mt.tune(Xs, ys, devices=farm, **_tune_kw())
    assert cache == sequential_tune[1] and best == sequential_tune[0]


class _CountingFarm(ProcessFarm):
    """A ProcessFarm that records how many jobs each map hands out."""

    def map(self, fn, items):
        items = list(items)
        self.maps = getattr(self, "maps", []) + [len(items)]
        return super().map(fn, items)


def test_trial_axis_farms_when_workers_exceed_folds(two_class_sines):
    Xs, ys = two_class_sines[0], two_class_sines[1]
    kw = _tune_kw()
    seq = mt.tune(Xs, ys, **kw, device="cpu")
    with _CountingFarm(3, platform="cpu") as farm:
        best, cache = mt.tune(Xs, ys, devices=farm, **kw)
        assert farm.maps[-1] == len(cache)       # one job per trial
    assert cache == seq[1] and best == seq[0]


@pytest.mark.parametrize("entry", ["tune", "evaluate"])
def test_implicit_process_farm_takes_the_callers_device(two_class_sines,
                                                        entry):
    """``devices="processes:2"`` builds its workers on the caller's
    ``device``: with ``device="cpu"`` they train on the CPU (here, where no
    card is present, workers on "cuda" would raise) and give the
    sequential result."""
    Xs, ys = two_class_sines[0], two_class_sines[1]
    if entry == "tune":
        kw = _tune_kw()
        seq = mt.tune(Xs, ys, **kw, device="cpu")
        assert mt.tune(Xs, ys, devices="processes:2", device="cpu",
                       **kw) == seq
        return
    kw = dict(nfolds=2, tuning_parameters={"d": [2, 3]}, n_cvfolds=2,
              tuning_maxiters=1, verbosity=-1,
              objective=mt.MisclassificationRate(),
              opts0=mt.MPSOptions(nsweeps=1, chi_max=6, d=2, verbosity=-5,
                                  log_level=-1, dtype="float64"))
    seq = mt.evaluate(Xs, ys, device="cpu", **kw)
    farmed = mt.evaluate(Xs, ys, devices="processes:2", device="cpu", **kw)
    for a, b in zip(farmed, seq):
        assert a["loss"] == b["loss"] and a["cache"] == b["cache"]


def test_farmed_evaluate_equals_sequential(two_class_sines, farm2):
    Xtr, ytr, Xte, yte = two_class_sines
    Xs, ys = np.concatenate([Xtr, Xte]), np.concatenate([ytr, yte])
    kw = dict(nfolds=2, tuning_parameters={"d": [2, 3]}, n_cvfolds=2,
              tuning_maxiters=1, verbosity=-1,
              objective=mt.MisclassificationRate(),
              opts0=mt.MPSOptions(nsweeps=1, chi_max=6, d=2, verbosity=-5,
                                  log_level=-1, dtype="float64"))
    seq = mt.evaluate(Xs, ys, device="cpu", **kw)
    for devices in (farm2, ["cpu", "cpu"]):
        farmed = mt.evaluate(Xs, ys, devices=devices, **kw)
        for a, b in zip(farmed, seq):
            assert a["loss"] == b["loss"] and a["cache"] == b["cache"]
            np.testing.assert_array_equal(a["test_inds"], b["test_inds"])
    # the JAX package's evaluate partitions the same folds
    theirs = mj.evaluate(Xs, ys, **{**kw, "objective":
                                    mj.MisclassificationRate(),
                                    "opts0": mj.MPSOptions(
                                        **kw["opts0"].to_dict())})
    for a, b in zip(seq, theirs):
        np.testing.assert_array_equal(a["test_inds"], b["test_inds"])
