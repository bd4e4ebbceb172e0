"""Operations and bytes of the bond kernels, from their shapes alone, and the
published peaks of one NVIDIA H100 SXM they are held against.

A frozen copy of the counts the port's kernels were designed against
(`_units`, `k1_work`, `k2_work`, `k12_work`, `bound`): a change to the
program does not move them, so a share of the roofline read from them
moves only with the device time.
"""

from __future__ import annotations

#: H100 SXM, float32 outside the tensor cores (NVIDIA's data sheet, 700 W).
PEAK_F32_FLOP_S = 67e12
#: H100 SXM HBM3 bandwidth.
PEAK_BYTES_S = 3.35e12


def _units(cplx: bool):
    """(float32 operations per multiply-add, per elementwise operation,
    bytes per value) of the kernels' scalar type."""
    return (8, 4, 8) if cplx else (2, 1, 4)


def k1_work(C, chi, d, N, *, emit_y=True, q=1, qr=True, mse=False,
            cplx=False):
    """(float32 operations, bytes) of one bond update: the bond tensor, the
    batch products and gradient, the step and q power steps (Newton-Schulz
    polar unless qr); each operand read once and each result written once
    (labels, weights and log-scales are float32)."""
    m, e, b = _units(cplx)
    P, K = chi * d, chi
    mac = C * P * P * chi + 2 * C * N * P * P + N * C * P
    ops = m * mac + e * (2 * N * P + 2 * C * N * P + 6 * C * P * P)
    if emit_y:
        ns = 0 if qr else (8 * (K * K * P + K ** 3 + P * K * K)
                           + 6 * (K * K * P + P * K * K))
        ops += q * (m * (2 * C * P * K * P + ns) + e * 6 * P * K)
    reads = b * (P * chi * (C + 1) + 2 * N * chi + 2 * N * d + P * K)
    reads += 4 * (N * C + N + (N if mse else 0))
    writes = b * (C * P * P + P * K)
    return ops, reads + writes


def k2_work(C, chi, d, N, cplx=False):
    """(float32 operations, bytes) of one split and environment advance."""
    m, e, b = _units(cplx)
    P, K = chi * d, chi
    ops = (m * (C * P * K * P + N * K * P)
           + e * (2 * C * P * K + 3 * K * K + 2 * N * P + 2 * C * P * K
                  + 3 * N * K))
    reads = b * (C * P * P + P * K + N * chi + N * d) + 4 * N
    writes = b * (C * chi * d * chi + chi * d * chi + N * chi) + 4 * N
    return ops, reads + writes


def k12_work(C, chi, d, N, *, Bb=1, refresh=True, q=1, mse=False,
             cplx=False):
    """(float32 operations, bytes) of Bb fused bond steps (the update with
    the Newton-Schulz power step, then the split), the bond tensor kept on
    chip."""
    o1, _ = k1_work(C, chi, d, N, emit_y=refresh, q=q, qr=False, mse=mse,
                    cplx=cplx)
    o2, _ = k2_work(C, chi, d, N, cplx=cplx)
    _, _, b = _units(cplx)
    P = chi * d
    reads = b * (Bb * chi * d * chi + C * chi * d * chi + (Bb + 1) * N * chi
                 + 2 * Bb * N * d + Bb * P * chi)
    reads += 4 * (N + N * C + N + (N if mse else 0))
    writes = b * (C * chi * d * chi + Bb * (chi * d * chi + N * chi
                                            + P * chi)) + 4 * Bb * N
    return Bb * (o1 + o2), reads + writes


def bound(work):
    """(bound_ms, bound_by): the least time of (operations, bytes) on the
    card, the larger of operations over the float32 peak and bytes over the
    bandwidth."""
    ops, nbytes = work
    t_ops, t_bytes = ops / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bond_step_work(shape: dict):
    """(operations, bytes) of one bond step of a fit of this shape (C, chi,
    d, N, q, cplx), as one fused step counts it."""
    return k12_work(shape["C"], shape["chi"], shape["d"], shape["N"], Bb=1,
                    q=shape["q"], cplx=shape["cplx"])
