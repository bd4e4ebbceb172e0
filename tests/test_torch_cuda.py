"""The port's CUDA bond kernels (K12, K12m) held against their plain
PyTorch versions on the card.  These tests need an NVIDIA GPU with nvcc and
skip without one.  This file imports nothing of JAX, so it runs where JAX
is not installed; tests/conftest.py does import JAX, hence --noconftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# the per-bond bound of tests/test_pallas_bond.py:73-82 (f32 reassociation)
RTOL, ATOL = 1e-4, 3e-5
SHAPE = dict(C=2, chi=25, d=5, N=100)      # the main path's bond shape


@pytest.fixture(scope="module")
def bk():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from mpstime_tpu_torch.kernels.build import load_library
    from mpstime_tpu_torch.ops import bond_kernels
    load_library()
    return bond_kernels


def _inputs(seed, Bb, C, chi, d, N):
    from mpstime_tpu_torch.ops.decomp import warm_sketch_init
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return dict(
        A=t(rng.standard_normal((Bb, chi, d, chi))),
        center=t(rng.standard_normal((C, chi, d, chi))),
        envx=t(rng.standard_normal((Bb, N, chi))),
        env0=t(rng.standard_normal((N, chi))), ls0=t(rng.standard_normal(N)),
        opp=t(0.3 * rng.standard_normal(N)),
        phil=t(rng.uniform(-0.8, 0.8, (Bb, N, d))),
        phir=t(rng.uniform(-0.8, 0.8, (Bb, N, d))),
        y1h=t(np.eye(C)[rng.integers(0, C, N)]), w=t(np.full(N, 1.0 / N)),
        V0=torch.stack([warm_sketch_init(chi * d, chi, np.float32, "cuda")] * Bb))


def _single(x, forward):
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0], x["env0"])
    return (x["A"][0], x["center"], le, re, x["ls0"], x["phil"][0],
            x["phir"][0], x["y1h"], x["w"], x["V0"][0], 0.05, 1e-10)


def _block(x):
    return (x["A"], x["center"], x["envx"], x["env0"], x["ls0"], x["phil"],
            x["phir"], x["y1h"], x["w"], x["V0"], 0.05, 1e-10)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,loss,bbopt,mr", [
    (True, 1, "KLD", "TSGO", None), (True, 3, "KLD", "TSGO", None),
    (False, 1, "KLD", "TSGO", None), (True, 1, "KLD", "GD", None),
    (True, 1, "MSE", "TSGO", None), (True, 1, "MSE", "GD", None),
    (True, 1, "KLD", "TSGO", 17)])
def test_k12_kernel_matches_plain(bk, forward, refresh, q, loss, bbopt, mr):
    x = _inputs(7, 1, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, max_rank=mr,
              loss=loss, bbopt=bbopt, opp_ls=x["opp"])
    n0 = bk.LAUNCHES["k12"]
    got = bk.bond_step(*_single(x, forward), orth="ns", **kw)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["k12"] == n0 + 1
    _close(got, bk.k12_plain(*_single(x, forward), **kw))


@pytest.mark.parametrize("Bb", [8, 7])
@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh", [True, False])
def test_k12m_kernel_matches_plain_and_chained_k12(bk, Bb, forward, refresh):
    x = _inputs(8, Bb, **SHAPE)
    kw = dict(forward=forward, refresh=refresh, power_iters=1)
    got = bk.bond_block_steps(*_block(x), **kw)
    torch.cuda.synchronize()
    _close(got, bk.k12m_plain(*_block(x), **kw))
    center, env, ls = x["center"], x["env0"], x["ls0"]
    for b in range(Bb):
        le, re = (env, x["envx"][b]) if forward else (x["envx"][b], env)
        center, core, env, ls, Q = bk.k12_cuda(
            x["A"][b], center, le, re, ls, x["phil"][b], x["phir"][b],
            x["y1h"], x["w"], x["V0"][b], 0.05, 1e-10, **kw)
        # one kernel: the block equals the chained single-bond launches
        _close((core, env, ls, Q), (got[1][b], got[2][b], got[3][b],
                                    got[4][b]), rtol=0, atol=1e-6)
    _close((center,), (got[0],), rtol=0, atol=1e-6)


def test_kernel_rejects_operands_off_the_card(bk):
    x = _inputs(9, 1, **SHAPE)
    args = list(_single(x, False))
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        bk.k12_cuda(*args, forward=False)
    args = list(_single(x, False))
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="float32"):
        bk.k12_cuda(*args, forward=False)


def test_fit_on_cuda_runs_the_kernels(bk):
    import mpstime_tpu_torch as mt
    data = np.load(Path(__file__).parent / "data" / "ecg200.npz")
    Xtr, ytr = data["X_train"][:40], data["y_train"][:40]
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(nsweeps=3, chi_max=12, d=3,
                                     verbosity=-1, log_level=-1),
        device="cuda")
    assert bk.LAUNCHES["k12m"] == 3 * 2 * 12 and bk.LAUNCHES["k12"] == 0
    assert bk.PLAIN_CALLS == {"k12": 0, "k12m": 0}
    assert trained.mps.center.is_cuda and len(info["sweep_seconds"]) == 3
    assert np.mean(mt.classify(trained, Xtr) == ytr) >= 0.9
