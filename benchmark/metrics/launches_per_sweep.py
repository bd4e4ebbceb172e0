"""Device operations per sweep inside the sweep's two ranges, every kind
(kernels, copies, fills) counted, the ranges themselves left out."""


def read(run):
    tr, sweeps = run.trace, sum(len(f.sweep_seconds) for f in run.traced)
    if tr is None or not tr.range_kernels or not sweeps:
        return None
    return tr.range_kernels / sweeps
