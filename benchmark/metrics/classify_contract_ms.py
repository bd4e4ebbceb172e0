"""The contraction in classify, ms a traced classify: the program's span
mps/classify/contract (contract_batch_scaled, argmax and the readback,
ending when the labels are on the host)."""

import program_spans as ps


def read(run):
    return ps.mean_ms(run, ps.CLASSIFY, "mps/classify/contract")
