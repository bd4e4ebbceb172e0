"""The 95th percentile of every sweep of the window, in ms, from the fits'
info["sweep_seconds"] (each ended by a sync of the card)."""

import numpy as np


def read(run):
    s = [x for f in run.fits for x in f.sweep_seconds]
    return float(np.percentile(s, 95)) * 1e3 if s else None
