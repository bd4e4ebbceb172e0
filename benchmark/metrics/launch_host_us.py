"""Host time of one kernel launch, us: the mean of the program's spans
mps/launch (a counted CUDA launch wrapper, entry to return) over the traced
fits; none where no kernel was launched (the plain versions on a CPU)."""

import program_spans as ps


def read(run):
    tr = ps.traces(run, ps.FIT)
    if tr is None:
        return None
    launches = [s for t in tr for s in t if s.name == "mps/launch"]
    if not launches:
        return None
    return 1e6 * ps.seconds(launches, "mps/launch") / len(launches)
