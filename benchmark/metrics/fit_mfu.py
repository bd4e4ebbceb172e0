"""The whole step's share of the card's float32 peak, %: the bond steps'
operations of every sweep in the traced window (as bond_roofline_pct
counts them) over the window's seconds, over 67 TFLOP/s."""


def read(run):
    tr = run.trace
    sweeps = sum(len(f.sweep_seconds) for f in run.traced)
    if tr is None or tr.window_s <= 0 or not sweeps:
        return None
    ops, _ = run.work.bond_step_work(run.shape)
    steps = sweeps * 2 * (run.shape["T"] - 1)
    return 100.0 * steps * ops / tr.window_s / run.work.PEAK_F32_FLOP_S
