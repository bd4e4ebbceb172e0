"""classify(trained, X_test), ms: the benchmark's clock around the call
(it returns host labels, so it ends after the card), averaged over the
untraced fits of a traced run."""


def read(run):
    fits = run.untraced
    return 1e3 * sum(f.classify_s for f in fits) / len(fits) if fits else None
