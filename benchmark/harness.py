"""One run of one cell: find the cell's configuration, traffic, limits and
metrics by name, set up, run the window of fits, judge what it produced,
and assemble the result line.

The window is the port's main path as a user runs it in a loop of trials
or folds: ``fit_mps(X_train, y_train, opts)`` on the card, then
``classify(trained, X_test)``, back to back, each fit from its own init
seed drawn from ``--seed`` and the fit's index.  The fit in progress when
the seconds are up runs to its end and counts.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

import check                                      # noqa: E402
import generator                                  # noqa: E402
import devtrace                                   # noqa: E402
import work                                       # noqa: E402


@dataclass
class FitRecord:
    index: int
    init_rng: int
    t0: float                       # host clock: fit_mps called
    fit_s: float                    # fit_mps, ended by its last sweep's sync
    classify_s: float               # classify, which returns host labels
    sweep_seconds: List[float]
    profiled: bool

    @property
    def t1(self) -> float:
        return self.t0 + self.fit_s + self.classify_s


@dataclass
class Run:
    """What a metric reader reads."""
    workload: str
    shape: dict                     # N, T, C, chi, d, q, cplx
    setup_s: float
    fits: List[FitRecord]
    trace: Optional[devtrace.TraceSummary] = None
    work = work

    @property
    def untraced(self) -> List[FitRecord]:
        return [f for f in self.fits if not f.profiled]

    @property
    def traced(self) -> List[FitRecord]:
        return [f for f in self.fits if f.profiled]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                    # the configuration file
    traffic: dict                   # the traffic file
    limits: dict                    # the cell's limits file
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str, spec_path: Path = REPO / "BENCHMARK.json"
              ) -> Cell:
    """The cell ``workload`` of BENCHMARK.json with its files, found by
    name: benchmark/traffic/<traffic>.json, benchmark/limits/<cell>.json and
    the configuration's ``file``; the metrics that apply to it."""
    spec = _json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {spec_path.name}: "
                       f"{sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]
    return Cell(workload, int(w["chips"]), _json(REPO / cfg["file"]),
                _json(HERE / "traffic" / f"{w['traffic']}.json"),
                _json(HERE / "limits" / f"{workload}.json"),
                [m for m in spec["end_to_end"] if applies(m)],
                [m for m in spec["per_layer"] if applies(m)])


def reader(name: str):
    """The reader of metric ``name``: benchmark/metrics/<name>.py's
    ``read(run)``, which returns a number or None (nothing to read)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def fit_seed(seed: int, index: int) -> int:
    """The init seed of fit ``index`` of a run (index -1: the warm-up)."""
    return int(generator.seed_rng(seed, 2, index + 1).integers(0, 2 ** 31))


def _cut(cell: Cell, data, cut: Optional[dict]):
    """A smaller copy of a cell for the CPU tests: the first rows, the first
    sites and fewer sweeps, or the cell as it is."""
    opts = dict(cell.config["options"])
    if not cut:
        return opts, data
    X_tr, y_tr, X_te, y_te = data
    n, m, T = cut["n_train"], cut["n_test"], cut["T"]
    keep = np.concatenate([np.flatnonzero(y_tr == c)[:n // 2]
                           for c in np.unique(y_tr)])
    opts.update({k: cut[k] for k in ("nsweeps", "chi_max") if k in cut})
    return opts, (X_tr[keep, :T], y_tr[keep], X_te[:m, :T], y_te[:m])


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool,
             t_start: float, device: str = "cuda", cut: dict = None,
             log=print) -> dict:
    """One run; returns the result line's object.  ``t_start``: the host
    clock when the process started loading.  ``device="cpu"`` and ``cut``
    serve the CPU tests only."""
    import torch
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.training import sweep as sweep_mod

    opts_d, data = _cut(cell, generator.make_data(cell.traffic, seed), cut)
    X_tr, y_tr, X_te, y_te = data
    base = mt.MPSOptions(**opts_d)
    o = opts_d
    shape = dict(N=len(y_tr), T=X_tr.shape[1], C=len(np.unique(y_tr)),
                 chi=o["chi_max"], d=o["d"], q=o["subspace_power_iters"],
                 cplx=np.dtype(o["dtype"]).kind == "c")
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_fit(i, init_rng, target, profiled):
        # only a sampled fit runs under the check's capture
        capture = (check.SweepCapture(sweep_mod, target) if target is not None
                   else contextlib.nullcontext())
        t0 = time.perf_counter()
        with torch.profiler.record_function(devtrace.SPAN_FIT), capture:
            trained, info, _ = mt.fit_mps(
                X_tr, y_tr, opts=base.replace(init_rng=init_rng),
                device=device)
        t1 = time.perf_counter()
        with torch.profiler.record_function(devtrace.SPAN_CLASSIFY):
            preds = mt.classify(trained, X_te)
        t2 = time.perf_counter()
        if target is not None:
            target.preds = preds
        return FitRecord(i, init_rng, t0, t1 - t0, t2 - t1,
                         list(info["sweep_seconds"]), profiled)

    # ---- set-up: one fit of one sweep and a classify at the cell's shapes
    # builds the kernels (first run in a checkout), the CUDA context, the
    # cuBLAS handles and the allocator's pools
    with contextlib.ExitStack() as traced:
        warm = base.replace(nsweeps=1, init_rng=fit_seed(seed, -1))
        trained, _, _ = mt.fit_mps(X_tr, y_tr, opts=warm, device=device)
        mt.classify(trained, X_te)
        del trained
        prof = None
        if trace_on:
            # the profiler's own start-up (CUPTI) is set-up, not window
            with torch.profiler.profile(activities=_activities(dev)):
                torch.ones(8, device=dev).sum()
                sync()
        sync()
        setup_s = time.perf_counter() - t_start

        # ---- the window
        pick = generator.seed_rng(seed, 3)
        k = cell.traffic["check"]["fits"]
        mids = cell.traffic["check"]["mid_sweeps"]
        n_trace = cell.traffic["trace_fits"] if trace_on else 0
        sample: List[check.CapturedFit] = []
        fits: List[FitRecord] = []
        summary = None
        w0 = time.perf_counter()
        i = 0
        while True:
            init_rng = fit_seed(seed, i)
            slot = i if i < k else int(pick.integers(0, i + 1))
            target = None
            if slot < k:
                ns = o["nsweeps"]
                pool = np.arange(1, ns - 1)
                chosen = pick.choice(pool, size=min(mids, len(pool)),
                                     replace=False).tolist()
                target = check.CapturedFit(i, init_rng,
                                           sorted({0, ns - 1, *chosen}))
                if slot < len(sample):
                    sample[slot] = target
                else:
                    sample.append(target)
            if i == 0 and n_trace:
                prof = traced.enter_context(torch.profiler.profile(
                    activities=_activities(dev)))
                traced.enter_context(torch.profiler.record_function(
                    devtrace.SPAN_WINDOW))
            fits.append(one_fit(i, init_rng, target, i < n_trace))
            if n_trace and i == n_trace - 1:
                sync()
                traced.close()
            i += 1
            if time.perf_counter() - w0 >= seconds and i >= n_trace:
                break
    if prof is not None:
        summary = devtrace.reduce_profile(prof)
        del prof
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    run = Run(cell.name, shape, setup_s, fits, summary)

    # ---- the metrics of this kind of run
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace_on and run.traced and run.untraced:
        a = statistics.mean(f.fit_s for f in run.traced)
        b = statistics.mean(f.fit_s for f in run.untraced)
        log(f"tracing overhead: a traced fit {a:.6f} s, an untraced fit "
            f"{b:.6f} s in the same run ({100 * (a / b - 1):+.2f} %)",
            file=sys.stderr)

    # ---- the comparison, once the window has closed and the peak is read
    t_ref = time.perf_counter()
    numbers = check.judge(sample, o, data, dev if dev.type == "cuda"
                          else "cpu")
    log(f"reference: {len(sample)} fits judged in "
        f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]}
              for k in check.NUMBERS if k in cell.limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": correct, "attempted": len(fits), "failed": 0,
              "metrics": metrics, "device": _device_info(dev, peak, summary)}
    if summary is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              summary.device_ops],
                               "idle_gaps": [list(x) for x in
                                             summary.idle_gaps]}
    result["checks"] = checks
    return result


def _activities(dev):
    from torch.profiler import ProfilerActivity
    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA]
            if dev.type == "cuda" else [ProfilerActivity.CPU])


def _device_info(dev, peak: int, summary) -> dict:
    import torch
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    return info
