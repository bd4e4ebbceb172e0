"""Where a padded fit's padded site directions gain weight: ECG200 at
``MPSOptions(chi_max=15, d=4, pad_to=(25, 5))`` (float32, the warm split,
orth "qr": every refresh bond K1 -> QR -> K2 with the rank cap 15).

Part 1, whole fits after 1, 3 and 10 sweeps, three ways: on the card
through the CUDA kernels, on the card through the kernels' plain versions
(the same QR), and on the CPU through the plain versions.  For each fit it
prints the share of the cores' squared entries on the padded site
direction (index 4), the four sites that hold the most of it, the state's
largest weight there at any site (``chip_smoke._padded_weight``, float64)
and the launches.

Part 2, bond by bond: a fit of 3 sweeps follows one route (the kernels, or
their plain versions), and at every refresh bond the same inputs also go
through the four chains K1 -> QR -> K2 with each of K1 and K2 either the
kernel or its plain version.  For each chain it sums over the sweep's
bonds the new core's weight on the padded direction (its share of the
two-site state's norm, float64), and counts the bonds where the chain's Y
has exactly zero padded rows, and where its kept directions differ from
the all-plain chain's.  Which K1 or K2 adds the excess shows there.

The padded directions see exactly zero features, so every entry there is
rounding that the QR of a bond's basis spreads into them.  Not a test;
run on a machine with a GPU from the repository root:

    python3 tests/torch_padded_probe.py

It writes the part-2 sums to ``chiprun_out/padded_probe.json``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import mpstime_tpu_torch as mt  # noqa: E402
from mpstime_tpu_torch.ops import bond_kernels as bk  # noqa: E402
from mpstime_tpu_torch.ops.decomp import _qr_orth  # noqa: E402

D_LIVE = 4
OPTS = dict(chi_max=15, d=4, pad_to=(25, 5), svd_alg="randomized_warm",
            verbosity=-1, log_level=-1)
CHAINS = (("kernel", "kernel"), ("kernel", "plain"), ("plain", "kernel"),
          ("plain", "plain"))


def report(label: str, trained) -> None:
    c = trained.mps.cores.abs() ** 2
    per = (c[:, :, D_LIVE:, :].sum((1, 2, 3)) / c.sum((1, 2, 3))).cpu().numpy()
    worst = np.argsort(-per)[:4]
    print(f"{label}: share {float(c[:, :, D_LIVE:, :].sum() / c.sum()):.3e}, "
          f"sites {worst.tolist()} hold "
          f"{[f'{v:.1e}' for v in per[worst]]}; the state's weight at most "
          f"{chip_smoke._padded_weight(trained.mps, D_LIVE):.3e}; launches "
          f"{chip_smoke._nonzero(bk.LAUNCHES)}", flush=True)


def whole_fits(X, y) -> None:
    for dev, route in (("cuda", "kernels"), ("cuda", "plain"),
                       ("cpu", "plain")):
        saved = bk.k1_cuda, bk.k2_cuda
        if dev == "cuda" and route == "plain":
            bk.k1_cuda, bk.k2_cuda = bk.k1_plain, bk.k2_plain
        try:
            for nsweeps in (1, 3, 10):
                bk.reset_counts()
                trained, _, _ = mt.fit_mps(X, y, device=dev, opts=mt.MPSOptions(
                    nsweeps=nsweeps, **OPTS))
                report(f"{dev} {route} {nsweeps} sweeps", trained)
        finally:
            bk.k1_cuda, bk.k2_cuda = saved


def _padded_rows(Y: torch.Tensor, forward: bool) -> torch.Tensor:
    """Y's rows on the padded site direction: forward rows are (left bond,
    site), backward rows (site, right bond)."""
    k = Y.shape[1]
    if forward:
        chi = Y.shape[0] // 5
        return Y.reshape(chi, 5, k)[:, D_LIVE:]
    return Y.reshape(5, -1, k)[D_LIVE:]


def _core_weight(core: torch.Tensor, center: torch.Tensor,
                 forward: bool) -> float:
    """The new core's share of the two-site state's norm on the padded site
    direction: core [chi, d, k] left-orthonormal and center [C, k, d, chi]
    forward, core [k, d, chi] right-orthonormal and center [C, chi, d, k]
    backward."""
    core, center = core.double(), center.double()
    if forward:
        R = torch.einsum("cmib,cnib->mn", center, center)
        w = torch.einsum("asm,mn,asn->", core[:, D_LIVE:], R,
                         core[:, D_LIVE:])
    else:
        L = torch.einsum("caim,cain->mn", center, center)
        w = torch.einsum("msb,mn,nsb->", core[:, D_LIVE:], L,
                         core[:, D_LIVE:])
    return float(w / (center ** 2).sum())


def _kept(core: torch.Tensor, forward: bool) -> torch.Tensor:
    return (core.abs().sum((0, 1)) if forward else core.abs().sum((1, 2))) > 0


def _chain(args, kw, k1_route: str, k2_route: str):
    (A_or_B, center_c, le, re, env_ls, phil, phir, y1h, w, V0, eta,
     cutoff) = args
    fwd = kw["forward"]
    k1 = bk.k1_plain if k1_route == "plain" else bk.k1_cuda
    k2 = bk.k2_plain if k2_route == "plain" else bk.k2_cuda
    BT, Y = k1(A_or_B, center_c, le, re, phil, phir, y1h, w, env_ls, V0, eta,
               forward=fwd, power_iters=kw["power_iters"], orth="qr",
               loss=kw["loss"], bbopt=kw["bbopt"])
    Q = _qr_orth(Y).contiguous()
    env, phi = (le, phil) if fwd else (re, phir)
    center, core, _, _ = k2(BT, Q, env, env_ls, phi, cutoff, forward=fwd,
                            max_rank=kw["max_rank"])
    return Y, center, core


def probe_bonds(X, y, route: str, nsweeps: int = 3) -> list:
    """A fit of ``nsweeps`` along ``route`` ("kernels" or "plain") with the
    four chains run beside every refresh bond on the bond's inputs.  Returns
    one dict a bond, chain -> (Y has exactly zero padded rows, the new
    core's weight on the padded direction, its kept directions differ from
    the all-plain chain's)."""
    orig = bk.qr_bond_step
    rows = []

    def probed(*args, plain, orth, split_tail, **kw):
        out = {}
        for c in CHAINS:
            Y, center, core = _chain(args, kw, *c)
            out[c] = (float((_padded_rows(Y, kw["forward"]) ** 2).sum()) == 0,
                      _core_weight(core, center, kw["forward"]),
                      _kept(core, kw["forward"]))
        base = out[("plain", "plain")][2]
        rows.append({c: (z, wt, bool((k != base).any()))
                     for c, (z, wt, k) in out.items()})
        return orig(*args, plain=route == "plain", orth=orth,
                    split_tail=split_tail, **kw)

    bk.qr_bond_step = probed
    try:
        mt.fit_mps(X, y, device="cuda", opts=mt.MPSOptions(nsweeps=nsweeps,
                                                           **OPTS))
    finally:
        bk.qr_bond_step = orig
    return rows


def bond_by_bond(X, y, route: str) -> dict:
    """``probe_bonds`` over 3 sweeps, summed a sweep and a chain: the new
    cores' padded weight, the bonds whose Y has exactly zero padded rows,
    and the bonds whose kept directions differ from the all-plain chain's."""
    rows = probe_bonds(X, y, route)
    nbond = 2 * (X.shape[1] - 1)
    summary = {}
    for s in range(len(rows) // nbond):
        part = rows[s * nbond:(s + 1) * nbond]
        for c in CHAINS:
            key = f"{route} trajectory, sweep {s + 1}, K1 {c[0]} K2 {c[1]}"
            summary[key] = dict(
                weight_sum=sum(r[c][1] for r in part),
                weight_max=max(r[c][1] for r in part),
                y_rows_zero=sum(r[c][0] for r in part),
                kept_differs=sum(r[c][2] for r in part), bonds=len(part))
            v = summary[key]
            print(f"{key}: padded weight of the new cores summed "
                  f"{v['weight_sum']:.3e} (largest {v['weight_max']:.3e}); Y "
                  f"with zero padded rows at {v['y_rows_zero']} of "
                  f"{v['bonds']} bonds; kept directions unlike the "
                  f"all-plain chain's at {v['kept_differs']}", flush=True)
    return summary


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    data = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    X, y = data["X_train"], data["y_train"]
    whole_fits(X, y)
    summary = {}
    for route in ("kernels", "plain"):
        summary.update(bond_by_bond(X, y, route))
    card = chip_smoke.smi_line()
    print(card)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "padded_probe.json").write_text(json.dumps(
        {"card": card, "bonds": summary}, indent=1))


if __name__ == "__main__":
    main()
