"""The host's time to issue a sweep, ms: the program's spans
mps/backward_bond and mps/forward_bond of the traced fits over their
sweeps (one pair a sweep).  Beside a sweep's seconds it says which side
paces the sweep: the host issuing, or the card running what was issued."""

import program_spans as ps

HALVES = ("mps/backward_bond", "mps/forward_bond")


def read(run):
    tr = ps.traces(run, ps.FIT)
    if tr is None:
        return None
    sweeps = sum(s.name == HALVES[0] for t in tr for s in t)
    if not sweeps:
        return None
    return 1e3 * sum(ps.seconds(t, *HALVES) for t in tr) / sweeps
