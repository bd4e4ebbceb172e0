"""Training series passed through every bond, per second: N x every sweep
completed in the window, over the seconds from the first fit's start to
the last fit's end (host preparation and classify included)."""


def read(run):
    sweeps = sum(len(f.sweep_seconds) for f in run.fits)
    span = run.fits[-1].t1 - run.fits[0].t0
    return run.shape["N"] * sweeps / span if span > 0 else None
