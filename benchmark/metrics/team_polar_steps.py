"""Newton-Schulz power steps a traced sweep whose tail after the step's two
products ran on the team's phases (every block of the cluster or grid), not
on the leader block: the ``steps`` of the program's spans mps/polar whose
``path`` is "team", over the traced fits' sweeps.  None where the traced
fits hold no mps/polar span (no power step ran on the card, or the program
records no such span)."""

import program_spans as ps


def read(run):
    tr = ps.traces(run, ps.FIT)
    if tr is None:
        return None
    polar = [s for t in tr for s in t if s.name == "mps/polar"]
    sweeps = sum(len(f.sweep_seconds) for f in run.traced)
    if not polar or not sweeps:
        return None
    return sum(s.attrs["steps"] for s in polar
               if s.attrs["path"] == "team") / sweeps
