"""The test set's preparation in classify, ms a traced classify: the
program's span mps/classify/encode (transform, encoding, cast to the
card)."""

import program_spans as ps


def read(run):
    return ps.mean_ms(run, ps.CLASSIFY, "mps/classify/encode")
