"""Host preparation of the training set, ms a traced fit: the program's
spans mps/fit/transform (transform_data) and mps/fit/encode (both
encode_dataset calls, the cast to the card included)."""

import program_spans as ps


def read(run):
    return ps.mean_ms(run, ps.FIT, "mps/fit/transform", "mps/fit/encode")
