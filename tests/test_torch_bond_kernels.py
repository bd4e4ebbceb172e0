"""The port's fused bond step: the plain versions of K12 and K12m held
against the JAX package's Pallas kernels (run in interpret mode, as
tests/test_pallas_bond.py runs them), plus the wrappers' dispatch and
operand checks.  The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpstime_tpu.ops import pallas_bond
from mpstime_tpu.ops.decomp import warm_sketch_init as jax_sketch
from mpstime_tpu_torch.ops import bond_kernels as bk
from mpstime_tpu_torch.training import sweep as tsweep

torch.set_num_threads(1)

# the per-bond bound of tests/test_pallas_bond.py:73-82 (f32 reassociation)
RTOL, ATOL = 1e-4, 3e-5


@pytest.fixture(scope="module")
def interpret():
    pallas_bond.set_interpret(True)
    jax.clear_caches()
    yield
    pallas_bond.set_interpret(False)
    jax.clear_caches()


def _block(seed, Bb=1, chi=6, d=3, C=2, N=12):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        A=rng.standard_normal((Bb, chi, d, chi)).astype(f32),
        center=rng.standard_normal((C, chi, d, chi)).astype(f32),
        envx=rng.standard_normal((Bb, N, chi)).astype(f32),
        env0=rng.standard_normal((N, chi)).astype(f32),
        ls0=rng.standard_normal(N).astype(f32),
        opp=(0.3 * rng.standard_normal(N)).astype(f32),
        phil=rng.uniform(-0.8, 0.8, (Bb, N, d)).astype(f32),
        phir=rng.uniform(-0.8, 0.8, (Bb, N, d)).astype(f32),
        y1h=np.eye(C, dtype=f32)[rng.integers(0, C, N)],
        w=np.full(N, 1.0 / N, f32),
        V0=np.stack([np.asarray(jax_sketch(chi * d, chi, f32))] * Bb),
    )


def _single_args(x, forward, conv):
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0], x["env0"])
    return tuple(conv(a) for a in (x["A"][0], x["center"], le, re, x["ls0"],
                                   x["phil"][0], x["phir"][0], x["y1h"],
                                   x["w"], x["V0"][0]))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


K12_GRID = [  # (refresh, q, loss, bbopt, max_rank)
    (True, 1, "KLD", "TSGO", None), (True, 3, "KLD", "TSGO", None),
    (False, 1, "KLD", "TSGO", None), (True, 1, "KLD", "GD", None),
    (True, 1, "MSE", "TSGO", None), (True, 1, "MSE", "GD", None),
    (True, 1, "KLD", "TSGO", 4), (False, 1, "MSE", "GD", 3),
]


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q,loss,bbopt,mr", K12_GRID)
def test_k12_plain_matches_pallas_k12(interpret, forward, refresh, q, loss,
                                      bbopt, mr):
    x = _block(11 + q + 2 * refresh)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, orth="ns",
              loss=loss, bbopt=bbopt)
    ref = pallas_bond.bond_step(
        *_single_args(x, forward, jnp.asarray), jnp.float32(0.05),
        jnp.float32(1e-10), max_rank=None if mr is None else jnp.int32(mr),
        opp_ls=jnp.asarray(x["opp"]), **kw)
    bk.reset_counts()
    got = bk.bond_step(*_single_args(x, forward, torch.from_numpy), 0.05,
                       1e-10, max_rank=mr, opp_ls=torch.from_numpy(x["opp"]),
                       **kw)
    assert bk.PLAIN_CALLS["k12"] == 1 and bk.LAUNCHES["k12"] == 0
    _close(got, ref)


def _blk_args(x, conv):
    return tuple(conv(x[k]) for k in ("A", "center", "envx", "env0", "ls0",
                                      "phil", "phir", "y1h", "w", "V0"))


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("refresh,q", [(True, 1), (False, 1)])
def test_k12m_plain_matches_pallas_k12m(interpret, forward, refresh, q):
    x = _block(31, Bb=4)
    kw = dict(forward=forward, refresh=refresh, power_iters=q, orth="ns")
    ref = pallas_bond.bond_block_steps(*_blk_args(x, jnp.asarray),
                                       jnp.float32(0.05), jnp.float32(1e-10),
                                       **kw)
    bk.reset_counts()
    got = bk.bond_block_steps(*_blk_args(x, torch.from_numpy), 0.05, 1e-10,
                              **kw)
    assert bk.PLAIN_CALLS["k12m"] == 1 and bk.LAUNCHES["k12m"] == 0
    _close(got, ref)


@pytest.mark.parametrize("forward", [False, True])
def test_k12m_plain_is_chained_k12_plain(forward):
    x = _block(41, Bb=3)
    a = _blk_args(x, torch.from_numpy)
    kw = dict(forward=forward, refresh=True, power_iters=1)
    center2, core_b, env_b, ls_b, q_b = bk.k12m_plain(*a, 0.05, 1e-10, **kw)
    center, env, ls = a[1], a[3], a[4]
    for b in range(3):
        le, re = (env, a[2][b]) if forward else (a[2][b], env)
        center, core, env, ls, Q = bk.k12_plain(
            a[0][b], center, le, re, ls, a[5][b], a[6][b], a[7], a[8],
            a[9][b], 0.05, 1e-10, **kw)
        for got, want in ((core_b[b], core), (env_b[b], env), (ls_b[b], ls),
                          (q_b[b], Q)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(center2, center, rtol=0, atol=0)


def _tie_break_case():
    """tests/test_pallas_bond.py:144-179 as a whole bond step: a frozen bond
    at eta 0 whose projected direction energies are w = [4, 2, 2, 2, 1, .5]
    with the cutoff boundary inside the tie group."""
    chi, d, C, N = 6, 2, 1, 4
    w = np.array([4.0, 2.0, 2.0, 2.0, 1.0, 0.5], np.float32)
    A = np.zeros((chi, d, chi), np.float32)
    A.reshape(chi * d, chi)[:chi] = np.eye(chi)
    center = np.zeros((C, chi, d, chi), np.float32)
    center[0, :, 0, :] = np.diag(np.sqrt(w))
    V0 = np.zeros((d * chi, chi), np.float32)
    V0[:chi] = np.eye(chi)
    env = np.zeros((N, chi), np.float32)
    env[:, 0] = 1.0
    phi = np.full((N, d), 0.5, np.float32)
    ops = (A, center, env, env, np.zeros(N, np.float32), phi, phi,
           np.ones((N, C), np.float32), np.full(N, 1.0 / N, np.float32), V0)
    return ops, float(np.float32(4.5 / w.sum()))


def test_cutoff_tie_break_matches_pallas(interpret):
    ops, cutoff = _tie_break_case()
    kw = dict(forward=False, refresh=False, orth="ns")
    ref = pallas_bond.bond_step(*(jnp.asarray(o) for o in ops),
                                jnp.float32(0.0), jnp.float32(cutoff), **kw)
    got = bk.bond_step(*(torch.from_numpy(o) for o in ops), 0.0, cutoff, **kw)
    _close(got, ref)
    # stable order: among the tied 2.0s the lower indices survive
    kept = (got[1] != 0).any(dim=-1).any(dim=-1).tolist()
    assert kept == [True, True, True, False, False, False]
    kept_ref = (np.asarray(ref[1]) != 0).any(axis=(1, 2)).tolist()
    assert kept == kept_ref


def test_launch_checks_operands_before_launching():
    x = _block(51, Bb=2)
    a = list(_blk_args(x, torch.from_numpy))
    calls = []

    def run(args, **kw):
        return bk._launch_k12m(*args[:5], None, *args[5:], 0.05, 1e-10,
                               forward=False, refresh=True, power_iters=1,
                               max_rank=None, loss="KLD", bbopt="TSGO",
                               launch=lambda *p: calls.append(p),
                               workspace_floats=lambda *s: 16, **kw)

    out = run(a)
    assert len(calls) == 1 and len(calls[0]) == 30
    assert [tuple(o.shape) for o in out] == [(2, 6, 3, 6), (2, 6, 3, 6),
                                             (2, 12, 6), (2, 12), (2, 18, 6)]
    bad = list(a)
    bad[3] = bad[3].double()
    with pytest.raises(ValueError, match="float32"):
        run(bad)
    bad = list(a)
    bad[2] = bad[2][:, :5]
    with pytest.raises(ValueError, match="shape"):
        run(bad)
    bad = list(a)
    bad[1] = bad[1].transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        run(bad)
    with pytest.raises(ValueError, match="power_iters"):
        bk._launch_k12m(*a[:5], None, *a[5:], 0.05, 1e-10, forward=False,
                        refresh=True, power_iters=0, max_rank=None,
                        loss="KLD", bbopt="TSGO", launch=None,
                        workspace_floats=lambda *s: 16)
    assert len(calls) == 1


def _fake_nvcc(path, body):
    path.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n"
                    + body)
    path.chmod(0o755)
    return str(path)


def test_build_compiles_once_per_source_digest(tmp_path, monkeypatch):
    from mpstime_tpu_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    log = tmp_path / "calls"
    nvcc = _fake_nvcc(tmp_path / "nvcc", (
        f"open({str(log)!r}, 'a').write(' '.join(args) + '\\n')\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"))
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    lib = build.build()
    assert lib == build.library_path() and lib.read_text() == "lib"
    assert build.build() == lib and build.last_build_seconds == 0.0
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    # sm_90a, and only the .cu sources on the command line
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert calls[0].endswith("bond_step.cu") and ".cuh" not in calls[0]
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    from mpstime_tpu_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    nvcc = _fake_nvcc(tmp_path / "nvcc",
                      "print('error: boom', file=sys.stderr)\nsys.exit(1)\n")
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="boom"):
        build.build()
    assert list((tmp_path / "_build").iterdir()) == []   # no partial library
    monkeypatch.undo()
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_unported_routes_raise():
    x = _block(61)
    args = _single_args(x, False, torch.from_numpy) + (0.05, 1e-10)
    with pytest.raises(NotImplementedError, match="items 3-4"):
        bk.bond_step(*args, forward=False, orth="qr")
    with pytest.raises(NotImplementedError, match="items 6-9"):
        bk.bond_step(*args, forward=False, orth="ns", stream_tile=4)
    with pytest.raises(NotImplementedError, match="CGD"):
        bk.bond_step(*args, forward=False, orth="ns", bbopt="CGD")
    # frozen bonds need no orthogonalisation: any orth runs
    bk.bond_step(*args, forward=False, refresh=False, orth="qr")


def test_auto_block_rule(monkeypatch):
    assert [tsweep._auto_block(T) for T in (2, 3, 4, 5, 8, 9, 96)] == \
        [1, 2, 3, 4, 6, 8, 8]
    monkeypatch.setattr(tsweep, "BOND_BLOCK", 3)
    assert tsweep._auto_block(96) == 3 and tsweep._auto_block(3) == 2
    monkeypatch.setattr(tsweep, "BOND_BLOCK", 1)
    assert tsweep._auto_block(96) == 1


def test_kernel_eligibility_matches_pallas_conditions():
    ok = dict(dtype=np.float32, loss="KLD", bbopt="TSGO", update_iters=1,
              rescale=(False, True), svd_alg="randomized_warm")
    for dev in ("cuda", "cpu", torch.device("cuda:0")):
        assert tsweep._kernel_eligible(device=dev, **ok)
    for change in (dict(dtype=np.float64), dict(dtype=torch.complex64),
                   dict(loss="MIXED"), dict(bbopt="CGD"),
                   dict(update_iters=2), dict(rescale=(True, True)),
                   dict(svd_alg="gram_eigh")):
        assert not tsweep._kernel_eligible(device="cuda", **{**ok, **change})
    assert tsweep.pallas_route_notice(torch.float32, "KLD", "TSGO", 1,
                                      (False, True), "randomized_warm",
                                      "cuda") is None
    note = tsweep.pallas_route_notice(torch.float32, "KLD", "TSGO", 2,
                                      (False, True), "svd", "cuda")
    assert "svd_alg='svd'" in note and "update_iters=2" in note
    assert tsweep.pallas_route_notice(torch.float32, "KLD", "TSGO", 2,
                                      (False, True), "svd", "cpu") is None
