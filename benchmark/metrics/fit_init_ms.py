"""Initial state of a fit, ms a traced fit: the program's spans
mps/fit/init (random_mps and the training tensors in fit_mps; the left
environments and cold subspace caches in the sweep's _init_state)."""

import program_spans as ps


def read(run):
    return ps.mean_ms(run, ps.FIT, "mps/fit/init")
