"""Share of the bond steps' roofline, %: the least time of the traced
sweeps' bond steps (2(T-1) a sweep, each counted from (C, chi, d, N) alone
as one fused step: work.bond_step_work) over the device time of every
operation inside the sweep's ranges."""


def read(run):
    tr = run.trace
    sweeps = sum(len(f.sweep_seconds) for f in run.traced)
    if tr is None or tr.range_kernel_s <= 0 or not sweeps:
        return None
    steps = sweeps * 2 * (run.shape["T"] - 1)
    least_ms, _ = run.work.bound(run.work.bond_step_work(run.shape))
    return 100.0 * steps * least_ms / 1e3 / tr.range_kernel_s
