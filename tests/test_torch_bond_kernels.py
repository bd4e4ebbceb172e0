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
from mpstime_tpu_torch.ops import bond_kernels_c as bkc
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
    # one sm_90a compile per .cu source (no .cuh on a command line), then
    # one link of their objects
    compiles, link = calls[:-1], calls[-1]
    assert len(calls) == 3 and link.startswith("-shared")
    assert all(" -c " in c and "arch=compute_90a,code=sm_90a" in c
               for c in compiles)
    assert sorted(c.rsplit("/", 1)[-1] for c in compiles) == [
        "bond_step.cu", "bond_step_c.cu"]
    assert not any(".cuh" in c for c in calls)
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
    # the batch-tiled route runs real and complex: the complex one through
    # the complex pieces (held against JAX in tests/test_torch_complex_dp.py)
    xc = {k: v.astype(np.complex64) if k in ("A", "center", "envx", "env0",
                                             "phil", "phir", "V0") else v
          for k, v in x.items()}
    bk.reset_counts()
    out = bkc.bond_step_c(*_single_args(xc, False, torch.from_numpy), 0.05,
                          1e-10, forward=False, orth="ns", stream_tile=4)
    n_tiles = -(-xc["env0"].shape[0] // 4)
    assert {k: v for k, v in bk.PLAIN_CALLS.items() if v} == {
        "k1c_grad": n_tiles, "k1c_update": 1, "k2c_split": 1,
        "k2c_env": n_tiles}
    assert out[0].dtype == torch.complex64 and torch.isfinite(out[2]).all()
    # CGD and the mixed loss are no kernel's: the sweep sends them to the
    # unfused route, and the kernels refuse them
    with pytest.raises(ValueError, match="CGD"):
        bk.bond_step(*args, forward=False, orth="ns", bbopt="CGD")
    with pytest.raises(ValueError, match="Newton-Schulz"):
        bk.bond_block_steps(*_blk_args(_block(62, Bb=2), torch.from_numpy),
                            0.05, 1e-10, forward=False, orth="qr")
    # a refresh bond under orth="qr" runs K1 -> QR -> K2 (here their plain
    # versions); a frozen one runs K12 under any orth
    bk.reset_counts()
    bk.bond_step(*args, forward=False, orth="qr")
    bk.bond_step(*args, forward=False, refresh=False, orth="qr")
    assert bk.PLAIN_CALLS == {**dict.fromkeys(bk.PLAIN_CALLS, 0), "k12": 1,
                             "k1": 1, "k2": 1}


def test_auto_block_rule(monkeypatch):
    assert [tsweep._auto_block(T) for T in (2, 3, 4, 5, 8, 9, 96)] == \
        [1, 2, 3, 4, 6, 8, 8]
    monkeypatch.setattr(tsweep, "BOND_BLOCK", 3)
    assert tsweep._auto_block(96) == 3 and tsweep._auto_block(3) == 2
    monkeypatch.setattr(tsweep, "BOND_BLOCK", 1)
    assert tsweep._auto_block(96) == 1


def test_kernel_eligibility_matches_pallas_conditions():
    # the route choice is the JAX package's _pallas_eligible
    # (sweep.py:125-165, interpret mode on the CPU): the bond kernels for
    # real float32, {KLD, MSE} x {TSGO, GD}, one update iteration,
    # rescale (False, True), randomized_warm and no cost tracking; every
    # other real configuration takes the unfused route
    ok = dict(dtype=np.float32, loss="KLD", bbopt="TSGO", update_iters=1,
              rescale=(False, True), svd_alg="randomized_warm")
    assert tsweep._kernel_eligible(**ok)
    assert tsweep._kernel_eligible(**{**ok, "loss": "MSE", "bbopt": "GD"})
    for change in (dict(dtype=np.float64), dict(dtype=torch.float64),
                   dict(loss="MIXED"), dict(bbopt="CGD"),
                   dict(update_iters=2), dict(rescale=(True, True)),
                   dict(svd_alg="gram_eigh"), dict(svd_alg="randomized"),
                   dict(track_cost=True)):
        assert not tsweep._kernel_eligible(**{**ok, **change})
    # complex64 with KLD + TSGO takes the complex kernels; complex128 and
    # any other complex loss or optimiser the unfused route
    assert tsweep._kernel_eligible(**{**ok, "dtype": torch.complex64})
    assert tsweep._kernel_eligible(**{**ok, "dtype": np.complex64})
    for change in (dict(dtype=torch.complex128), dict(bbopt="GD"),
                   dict(loss="MSE"), dict(svd_alg="gram_eigh")):
        assert not tsweep._kernel_eligible(
            **{**ok, "dtype": torch.complex64, **change})
    # the ritz route is not the warm kernels' route; its Jacobi-rotated
    # sweeps run K12cr on complex64 with the same terms (sweep.py:319-348),
    # every other ritz sweep the unfused route
    ritz = {**ok, "svd_alg": "randomized_warm_ritz"}
    for dtype in (torch.float32, torch.complex64):
        assert not tsweep._kernel_eligible(**{**ritz, "dtype": dtype})
    for rot in ("jacobi", "jacobi_warm"):
        assert tsweep._ritz_fused(**{**ritz, "dtype": torch.complex64},
                                  ritz_rot=rot)
    for change in (dict(ritz_rot="eigh"), dict(ritz_rot="eigh_r"),
                   dict(ritz_rot="track"), dict(dtype=torch.float32),
                   dict(dtype=torch.complex128), dict(track_cost=True),
                   dict(bbopt="GD"), dict(update_iters=2),
                   dict(svd_alg="randomized_warm")):
        kw = {**ritz, "dtype": torch.complex64, "ritz_rot": "jacobi",
              **change}
        assert not tsweep._ritz_fused(**kw)
    assert tsweep.pallas_route_notice(torch.float32, "KLD", "TSGO", 1,
                                      (False, True), "randomized_warm",
                                      "cuda") is None
    note = tsweep.pallas_route_notice(torch.float32, "KLD", "TSGO", 2,
                                      (False, True), "svd", "cuda",
                                      track_cost=True)
    assert "svd_alg='svd'" in note and "update_iters=2" in note
    assert "track_cost" in note
    assert tsweep.pallas_route_notice(torch.float32, "KLD", "TSGO", 2,
                                      (False, True), "svd", "cpu") is None


# ---- the cluster K12 and K12m: entry points ---------------------------------

def _record_launches(monkeypatch):
    """Replace the library's launchers with ones that record (entry, C
    arguments) and launch nothing."""
    calls = []

    def cuda_launch(device, entry, workspace="mpst_k12_workspace_floats"):
        return (lambda *args: calls.append((entry, args))), (lambda *s: 16)

    monkeypatch.setattr(bk, "_cuda_launch", cuda_launch)
    return calls


@pytest.mark.parametrize("cluster", [None, 1, 8])
@pytest.mark.parametrize("key", ["k12", "k12m"])
def test_k12_wrappers_launch_the_cluster_entry(monkeypatch, key, cluster):
    """k12_cuda / k12m_cuda (cluster None; 1 and 8 through the cluster
    launch the checks at other sizes call) launch the cluster entry with
    the one-block entry's arguments and the cluster size (default
    K12M_CLUSTER), counted under the kernel's name; k12m_block_cuda
    launches the one-block entry, counted apart."""
    calls = _record_launches(monkeypatch)
    x = _block(71, Bb=1 if key == "k12" else 3)
    blk = _blk_args(x, torch.from_numpy) + (0.05, 1e-10)
    kw = dict(forward=True, power_iters=3, max_rank=4, bbopt="GD")
    if key == "k12":
        kw.update(loss="MSE", opp_ls=torch.from_numpy(x["opp"]))
    bk.reset_counts()
    if cluster is not None:
        raw = dict(kw, refresh=True, loss=kw.get("loss", "KLD"))
        opp = raw.pop("opp_ls", None)
        bk._k12m_cluster(cluster, *blk[:5], opp, *blk[5:], **raw)
    elif key == "k12":
        out = bk.k12_cuda(*_single_args(x, True, torch.from_numpy), 0.05,
                          1e-10, **kw)
        assert [tuple(o.shape) for o in out] == [(2, 6, 3, 6), (6, 3, 6),
                                                 (12, 6), (12,), (18, 6)]
    else:
        bk.k12m_cuda(*blk, **kw)
    bk.k12m_block_cuda(*blk, **kw)
    (e1, a1), (e2, a2) = calls
    assert (e1, e2) == ("mpst_k12m_cluster_launch", "mpst_k12m_launch")
    assert a1[:11] == a2[:11]                      # the same operands
    assert a1[17:-1] == a2[17:]                    # the same sizes and flags
    assert a1[-1] == (bk.K12M_CLUSTER if cluster is None else cluster)
    assert (a1[5] is not None) == (key == "k12")   # opp_ls, MSE only
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {
        **({key: 1} if cluster is None else {}), "k12m_block": 1}


@pytest.mark.parametrize("route", ["bond_step", "bond_block_steps"])
def test_routes_on_the_card_reach_the_cluster_k12m(monkeypatch, route):
    """The fused routes' CUDA dispatch runs the cluster K12m: one K12 for
    a bond_step off the qr route, one K12m for a block; nothing plain, no
    one-block launch."""
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(bk, "_device_of", lambda t: "cuda")
    bk.reset_counts()
    if route == "bond_step":
        bk.bond_step(*_single_args(_block(72), False, torch.from_numpy),
                     0.05, 1e-10, forward=False, orth="ns")
        key = "k12"
    else:
        bk.bond_block_steps(*_blk_args(_block(72, Bb=2), torch.from_numpy),
                            0.05, 1e-10, forward=False)
        key = "k12m"
    assert [(e, a[-1]) for e, a in calls] == [
        ("mpst_k12m_cluster_launch", bk.K12M_CLUSTER)]
    assert {k: v for k, v in bk.LAUNCHES.items() if v} == {key: 1}
    assert sum(bk.PLAIN_CALLS.values()) == 0


# ---- the leader block's Newton-Schulz tail: its shape rule and counter ------

@pytest.mark.parametrize("chi,d,is_complex,path", [
    (25, 5, False, "block"), (25, 5, True, "team"), (40, 5, False, "block"),
    (44, 5, False, "team"), (64, 5, False, "team"), (64, 5, True, "team"),
    (72, 5, False, "team"), (192, 5, False, "team"), (6, 3, True, "team"),
    (192, 5, True, "team")])
def test_polar_path_follows_the_leader_buffers(chi, d, is_complex, path):
    """A real Newton-Schulz step's tail runs on the leader block where X,
    X' [chi*d, chi], their transposes and Gm and Mq^T [chi, chi], float32
    rows padded to an odd number of 16-byte vectors, fit in POLAR_SMEM
    (csrc/bond_step.cuh's polar_in_block); a complex one, or one past that,
    on the team."""
    def ld(n):
        return 4 * ((n + 3) // 4 | 1)

    P = chi * d
    nbytes = bk.polar_smem_bytes(chi, d)
    assert nbytes == (2 * P * ld(chi) + 2 * chi * ld(P)
                      + 2 * chi * ld(chi)) * 4
    assert (nbytes <= bk.POLAR_SMEM and not is_complex) == (path == "block")
    assert bk.polar_path(chi, d, is_complex) == path


def test_polar_smem_bytes_at_the_cells_shape():
    # chi 25, d 5: rows of 28 and 132 floats, 58.6 KB of the leader's
    # 160 KB; chi 40: 146.3 KB, chi 44: 166.4 KB
    assert bk.polar_smem_bytes(25, 5) == 60000
    assert bk.polar_smem_bytes(40, 5) == 149760 <= bk.POLAR_SMEM == 163840
    assert bk.polar_smem_bytes(44, 5) == 170368 > bk.POLAR_SMEM


def test_reset_counts_clears_polar_steps():
    bk.reset_counts()
    bk.count_polar(25, 5, 3)
    bk.count_polar(25, 5, 0)
    bk.count_polar(25, 5, 2, is_complex=True)
    assert bk.POLAR_STEPS == {"block": 3, "team": 2}
    bk.reset_counts()
    assert bk.POLAR_STEPS == {"block": 0, "team": 0}


def _zero_operands(chi, d, dtype, Bb=1, C=2, N=4):
    """Operands of every bond kernel wrapper at (chi, d), all zeros; labels,
    weights and log-scales float32."""
    P = chi * d

    def z(*shape, real=False):
        return torch.zeros(shape, dtype=torch.float32 if real else dtype)

    return dict(A=z(Bb, chi, d, chi), center=z(C, chi, d, chi),
                envx=z(Bb, N, chi), env0=z(N, chi), ls=z(N, real=True),
                phil=z(Bb, N, d), phir=z(Bb, N, d), y1h=z(N, C, real=True),
                w=z(N, real=True), V0=z(Bb, P, chi), G=z(C, P, d, chi))


def _wrapper_call(key, x, flag, orth, q):
    """Launch the counted wrapper ``key`` on _zero_operands ``x``: flag is
    refresh (K12, K12m, K12c, K12mc) or emit_y (K1, K1c, K1b, K1c-update),
    orth the power step's (K1 and the pieces)."""
    single = (x["A"][0], x["center"], x["envx"][0], x["env0"], x["ls"],
              x["phil"][0], x["phir"][0], x["y1h"], x["w"], x["V0"][0], 0.05,
              1e-10)
    block = (x["A"], x["center"], x["envx"], x["env0"], x["ls"], x["phil"],
             x["phir"], x["y1h"], x["w"], x["V0"], 0.05, 1e-10)
    k1 = (x["A"][0], x["center"], x["envx"][0], x["env0"], x["phil"][0],
          x["phir"][0], x["y1h"], x["w"])
    kw = dict(forward=False, power_iters=q)
    if key in ("k12", "k12c"):
        fn = bk.k12_cuda if key == "k12" else bkc.k12c_cuda
        return fn(*single, refresh=flag, **kw)
    if key in ("k12m", "k12mc"):
        fn = bk.k12m_cuda if key == "k12m" else bkc.k12mc_cuda
        return fn(*block, refresh=flag, **kw)
    kw.update(orth=orth)
    if key == "k1":
        return bk.k1_cuda(*k1, None, x["V0"][0], 0.05, emit_y=flag, **kw)
    if key == "k1c":
        return bkc.k1c_cuda(*k1, x["V0"][0], 0.05, emit_y=flag, **kw)
    if key in ("k1b", "k1c_update"):
        fn = bk.k1b_cuda if key == "k1b" else bkc.k1c_update_cuda
        return fn(x["A"][0], x["center"], x["G"], x["V0"][0], 0.05,
                  emit_y=flag, **kw)
    fn = bk.k1_tail_cuda if key == "k1_tail" else bkc.k1c_tail_cuda
    return fn(x["G"], x["V0"][0], **kw)


@pytest.mark.parametrize("key,chi,d,Bb,flag,orth,q,want", [
    ("k12", 6, 3, 1, True, "ns", 3, {"block": 3}),
    ("k12", 6, 3, 1, False, "ns", 3, {}),
    ("k12", 72, 5, 1, True, "ns", 1, {"team": 1}),
    ("k12m", 6, 3, 3, True, "ns", 3, {"block": 9}),
    ("k12m", 6, 3, 3, False, "ns", 1, {}),
    ("k12c", 25, 5, 1, True, "ns", 3, {"team": 3}),
    ("k12c", 64, 5, 1, True, "ns", 3, {"team": 3}),
    ("k12mc", 6, 3, 4, True, "ns", 2, {"team": 8}),
    ("k1", 6, 3, 1, True, "ns", 2, {"block": 2}),
    ("k1", 6, 3, 1, True, "qr", 2, {}),
    ("k1c", 6, 3, 1, True, "ns", 3, {"team": 3}),
    ("k1b", 25, 5, 1, True, "ns", 1, {"block": 1}),
    ("k1b", 6, 3, 1, False, "ns", 1, {}),
    ("k1b", 72, 5, 1, True, "ns", 2, {"team": 2}),
    ("k1c_update", 6, 3, 1, True, "ns", 3, {"team": 3}),
    ("k1c_update", 6, 3, 1, True, "qr", 3, {}),
    ("k1_tail", 6, 3, 1, None, "ns", 1, {"block": 1}),
    ("k1_tail", 192, 2, 1, None, "ns", 1, {"team": 1}),
    ("k1c_tail", 6, 3, 1, None, "ns", 3, {"team": 3}),
    ("k1c_tail", 6, 3, 1, None, "qr", 3, {})])
def test_counted_wrappers_count_polar_steps(monkeypatch, key, chi, d, Bb,
                                            flag, orth, q, want):
    """Each counted cluster or grid launch adds power_iters Newton-Schulz
    power steps a refreshing bond (refresh, or emit_y under orth "ns") to
    POLAR_STEPS under polar_path's key; frozen bonds, passed-through
    iterates and the qr route add none.  Nothing is launched."""
    calls = _record_launches(monkeypatch)
    is_complex = key in ("k12c", "k12mc", "k1c", "k1c_update", "k1c_tail")
    x = _zero_operands(chi, d, torch.complex64 if is_complex
                       else torch.float32, Bb=Bb)
    bk.reset_counts()
    _wrapper_call(key, x, flag, orth, q)
    assert len(calls) == 1 and bk.LAUNCHES[key] == 1
    assert bk.POLAR_STEPS == {"block": 0, "team": 0, **want}
    bk.reset_counts()
