"""Host preparation of a fit, ms: the benchmark's clock around fit_mps less
the fit's sweeps, averaged over the untraced fits of a traced run
(transform, encoding, the initial MPS, the environments' set-up and the
final normalisation)."""


def read(run):
    fits = run.untraced
    if not fits:
        return None
    return 1e3 * sum(f.fit_s - sum(f.sweep_seconds) for f in fits) / len(fits)
