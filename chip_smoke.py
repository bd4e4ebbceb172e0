#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port (mpstime_tpu_torch) on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero:
  1. device: the card's name and power limit, torch/CUDA versions; TF32 off.
  2. build: compile the kernels from mpstime_tpu_torch/csrc/.
  3. kernel vs plain: K12, K12m, K1 and K2 against their plain PyTorch
     versions on the card at the main-path shape (C=2, chi=25, d=5, N=100)
     over their variant grids, K12m against chained K12 launches, the
     degenerate cutoff tie-break case (through K12 and through K2), and a
     whole QR bond (K1 -> torch.linalg.qr -> K2) against the plain QR bond
     around the same QR call; then each kernel's time beside its plain
     version's and the QR's.
  4. main path: fit_mps on ECG200 at the default MPSOptions (f32, chi 25,
     d 5, 10 sweeps, KLD -> K12m), device="cuda", then classify; checks
     the launch counts, the plain-version counts and the test accuracy.
     Then a 2-sweep MSE fit (-> K12) through the same entry point, its
     counts read from its own run, the default fit at two more init
     seeds (accuracy reported, not held to the floor), and two default
     sweeps under torch.profiler (device time by kernel).
  5. qr path: fit_mps with orth_alg="qr", subspace_refresh_every=2 (refresh
     sweeps -> K1 -> QR -> K2 per bond, frozen sweeps -> K12m), counts read
     from its own run, then classify; then a refresh and a frozen sweep of
     it under torch.profiler (device time by kernel).
  6. unfused path: a 2-sweep gram_eigh fit with track_cost on the card,
     which runs no kernel and no plain version of one.
  7. complex kernels: K12c, K12mc (Bb=4), K1c and K2c against their plain
     versions on complex64 operands at the main-path shape, K12mc against
     chained K12c launches, and a whole complex QR bond (K1c -> realified
     QR -> K2c); then each one's time beside its plain version's.
  8. complex path: fit_mps on ECG200 with MPSOptions(encoding="fourier")
     (complex64, d 5, chi 25, q 3, 10 sweeps -> one K12c per bond), its
     counts read from its own run, accuracy held to the JAX lane's band,
     then classify, and the same fit at two more init seeds (reported);
     then the qr route of it (K1c -> QR -> K2c on refresh sweeps, K12mc
     blocks of 4 on frozen ones) and a profiled sweep of each route.
  9. ritz kernel: K12cr against its plain version on complex64 operands at
     the ritz cell's bond shape (C=2, chi=64, d=5, N=100) and a small one,
     over directions, refresh and frozen bonds, q 1 and 3, 6 and 24 Jacobi
     rounds and a rank cap, holding the raw outputs and the gauge
     invariants; then its time beside its plain version's and its bound.
 10. ritz path: fit_mps on ECG200 with MPSOptions(encoding="fourier",
     chi_max=64, nsweeps=5) (complex64, d 5, q 1, randomized_warm_ritz:
     two exact sweeps on the unfused route, then one K12cr per bond), its
     counts read from its own run, accuracy held to the JAX lane's ritz
     band, then classify, and the same fit with an exact eigh on every
     sweep (no kernel) and at two more init seeds (reported); then one
     tracked sweep under torch.profiler.
 11. dp kernels: K1a, K1b, K2-split and K2-env against their plain versions
     at the main-path shape (unit environment rows, as a sweep hands them
     over) over their variant grids, the chain K1a -> K1b -> K2-split ->
     K2-env on one shard against K12 and against K1 -> QR -> K2, one bond on
     two shards of the card against one shard, the batch-tiled bond step
     (stream_tile=32) against the unstreamed one; then each kernel's time
     beside its plain version's.
 12. dp path: fit_mps on ECG200 at the default MPSOptions on make_mesh(1)
     (every bond K1a -> sum -> K1b -> K2-split -> K2-env), its counts read
     from its own run, its sweep-1 train KLD against the single-device
     fused fit's, then classify; the same fit on two shards of the card
     (Mesh(["cuda:0"] * 2)); one sweep of each under torch.profiler.
 13. complex dp kernels: K1c-grad, K1c-update, K2c-split and K2c-env against
     their plain versions on complex64 operands at the complex main-path
     shape (C=2, chi=25, d=5, N=100, unit environment rows) over both
     directions, q 1 and 3, emit_y 0/1, orth ns/qr and a rank cap; the chain
     on one shard against K12c (ns) and K1c -> realified QR -> K2c (qr), one
     bond on two shards of the card against one shard, the complex
     batch-tiled bond step (stream_tile=32) against the unstreamed one; then
     each kernel's time beside its plain version's.
 14. complex dp path: fit_mps on ECG200 with MPSOptions(encoding="fourier")
     (complex64, chi 25, q 3, 10 sweeps) on make_mesh(1) (every bond
     K1c-grad -> sum -> K1c-update -> K2c-split -> K2c-env), its counts read
     from its own run, its sweep-1 train KLD against the single-device fused
     fourier fit's (K12c), then classify; the same fit on two shards of the
     card; one sweep of it under torch.profiler.
 15. split-tail kernels: K1-tail and K1c-tail against their plain versions
     (K1-tail's body over a cooperative grid of K1_TAIL_BLOCKS blocks)
     at the main-path shape and at chi 192 (C 2, d 5) over both directions,
     orth ns and qr, q 1 and 3; bond_step(split_tail=True) against K12 (ns)
     and K1 -> QR -> K2 (qr), bond_step_c(split_tail=True) (q 3) against
     K12c and K1c -> QR -> K2c, the one-shard dp steps and stream_tile=32
     with the split tail against the same calls without it; then the fused
     and split forms of a backward refresh bond timed in turns at chi 192,
     256 and 320 (real, q 1, ns and qr) and 128 and 192 (complex, q 3, ns),
     K1's (K1c's) in-kernel power steps against a K1-tail (K1c-tail) launch
     at chi 192 and 320, the chi from which the split form wins
     (SPLIT_TAIL_CHI), and each tail kernel's time at the main-path shape
     beside its plain version's.
 16. split-tail path: fit_mps on ECG200 at the default MPSOptions and with
     encoding="fourier" on cuda with bond_kernels.SPLIT_TAIL_CHI = 0 (every
     refresh bond K1 -> K1-tail -> K2, K1c -> 3 K1c-tail -> K2c), counts
     read from each run, sweep-1 train KLD against the fused fits', accuracy
     held as theirs; one sweep of the real fit under torch.profiler.
 17. cluster kernels: K12c (one bond over a thread-block cluster) against
     the one-block K12mc at Bb = 1 bit for bit over the complex grid at the
     main-path shape and at chi 128 and 192, K12cr bit for bit across
     cluster sizes 1-16 (those the card can place) over its ritz grid at
     chi 64 and chi 8, a cluster of 32 blocks refused by the wrapper and,
     past it, by the card, the occupancy of clusters, per-call ms of K12c
     against the one-block K12mc at Bb = 1 in turns and of K12cr at each
     cluster size, and a bond's time by part (frozen, each power step, the
     Jacobi rounds).
 18. cluster K1c and K1c-update: each (one complex bond update over a
     thread-block cluster) against its one-block kernel bit for bit, both
     outputs (BT, Y), over both directions x (emit_y, q, orth) in (1, 1,
     qr), (1, 3, qr), (0, 1, qr), (1, 1, ns), (1, 3, ns) at the main-path
     shape and q 3 (qr and ns) at chi 128, K1c-update's gradient from
     K1c-grad on the same inputs, and equal across every cluster size the
     card places; a cluster of 32 blocks refused by the wrapper and, past
     it, by the card, with nothing launched; the occupancy of clusters;
     their ptxas entries; per-call ms of each against its one-block kernel
     in turns, and by cluster size over 5 interleaved rounds.
 19. cluster K12, K12m and K12mc: each (a block of bonds over a thread-block
     cluster) against its one-block kernel bit for bit, all five outputs:
     K12 and K12m at Bb 1, 2, 4 and 8 over both directions x (refresh q 1,
     refresh q 3, frozen) with TSGO, and GD, a rank cap of 17, MSE at
     Bb = 1 and the cutoff tie-break; K12mc at Bb 1-4 over both directions x
     (refresh q 1, q 3, frozen) and a rank cap; real and complex at chi 128;
     at the default cluster and at every size the card places; a cluster of
     32 blocks refused by the wrapper and, past it, by the card, with
     nothing launched; the occupancy of clusters; their ptxas entries;
     per-call ms of K12 (a refresh bond, q 1), K12m (an 8-bond refresh
     block) and K12mc (a frozen 4-bond block) against their one-block
     kernels in turns, and by cluster size over 5 interleaved rounds.
 20. cluster K1a and K1c-grad: each (one shard's gradient over a
     thread-block cluster) against its one-block kernel bit for bit over
     both directions x (chi, N) in (25, 100), (25, 50), (25, 32), (128,
     100), K1a with KLD and MSE (with its log-scales), at the default
     cluster and at every size the card places; a cluster of 32 blocks
     refused by the wrapper and, past it, by the card, with nothing
     launched; the occupancy of clusters; their ptxas entries; per-call ms
     of each against its one-block kernel in turns, and by cluster size
     over 5 interleaved rounds.
 21. cluster K1 and K1b: each (one real bond update over a thread-block
     cluster) against its one-block kernel bit for bit, both outputs (BT,
     Y), over both directions x (emit_y, q, orth) in (1, 1, qr), (1, 3,
     qr), (0, 1, qr), (1, 1, ns), (1, 3, ns) at the main-path shape, GD at
     (1, 1, qr) and q 3 (qr and ns) at chi 128; K1 also with MSE (its
     log-scales), N 50 and 32 at (1, 1, qr) and a backward bond at chi 192
     (q 1, qr); K1b's gradient from the cluster K1a on the same inputs; at
     the default cluster and at every size the card places; a cluster of
     32 blocks refused by the wrapper and, past it, by the card, with
     nothing launched; the occupancy of clusters; their ptxas entries;
     per-call ms of each against its one-block kernel in turns (K1 the qr
     refresh bond, K1b the dp bond under ns), and by cluster size over 5
     interleaved rounds; fails unless each cluster kernel beats its
     one-block kernel and each default size is the fastest within the
     spread.
 22. cluster K2, K2c, K2-split and K2c-split: each (the split, and for K2
     and K2c the environment advance, over a thread-block cluster) against
     its one-block kernel bit for bit, every output (center, core, env and
     env_ls; the splits' center, core and Qm), over both directions x
     max_rank None and 4 x cutoff 1e-10 and 0.05 (which cuts) at the
     main-path shape, chi 64 and 128, K2 and K2c at N 50 and 32, a basis
     with five zero-energy columns and the tie-break bond (complex64 for
     K2c and K2c-split); at the default cluster and at every size the card
     places; a cluster of 32 blocks refused by the wrapper and, past it, by
     the card, with nothing launched; the occupancy of clusters; their
     ptxas entries; device ms a call (20 calls queued behind a spin of the
     card) of each against its one-block kernel in turns (K2 and K2c a qr
     refresh bond's, the splits a dp bond's), and by cluster size over 5
     interleaved rounds, failing as phase 21 does; a backward K2's and
     K2c's device ms by part (projection, energies + mask, emission,
     advance) from prefixes of the body; the host's us a launch of the
     cluster and one-block forms, through the wrapper and the bare C entry
     (1000 unsynced calls each).
 23. row-tile K2-env and K2c-env, grid K1-tail and K1c-tail: K2-env and
     K2c-env (ceil(N / rows) independent blocks of the one-block body)
     against their one-block kernels bit for bit over both directions x N
     1, 7, 32, 50, 100 x rows a block 1-32 and the default; K1-tail and
     K1c-tail (K1-tail's body over every block of a cooperative grid)
     against theirs over both directions x chi 25 and 192 x orth ns and qr
     x q 1 and 3 at grids of 1, 2, 16, 66 and the most blocks the card
     holds; a grid one past the most refused by the card, nothing
     launched; their ptxas entries; device ms a call of K2-env and K2c-env
     against one block in turns at N 100, 50, 32, by rows a block and
     unstaged (Qm and the factors from global memory, not shared), and of
     K1-tail and K1c-tail at chi 25 (queued) and at chi 192-320 (128-192
     complex; events) in turns and by grid size 16, 32, 66, 132; fails
     unless each beats its one-block kernel at those shapes and each
     default is the fastest within the spread.
 24. impute path: fit_mps on ECG200 with MPSOptions(nsweeps=3, chi_max=25,
     d=5, dtype="float32") on cuda (K12m, counts read from its own run),
     init_imputation_problem (test_encoding, dx 1e-4, G 20001) on the card,
     impute_batch by median over min(35, class count) instances of the
     first test class with one 20 % MAR window (the median of 3 synced
     calls after a warm-up, the MAE on the missing sites, one call under
     torch.profiler for the card's busy share), mps_impute of one instance
     by median, mean, mode (with and without max_jump), ITS (3
     trajectories; rejection_threshold 2.5) and kNN, get_cdfs and
     sample_trajectories(n=16); checks finiteness, known sites returned
     exactly, monotone cdfs from 0 to 1, the median's MAE over 5 instances
     of 30 % windows below flatBaseline's, and ITS reproducing under rseed.
 25. impute vs cpu: the same weights cast to float64 on the card and on the
     CPU, impute_windows (3 windows x 8 instances) by median, mean and mode;
     every site within one grid step of the CPU's, with the count of sites
     a grid step apart and the float32 card run's MAE against float64.
 26. complex impute path: fit_mps with MPSOptions(encoding="fourier",
     nsweeps=3) (complex64, K12c, counts from its own run) then
     impute_batch as in 24 (time, MAE, finiteness, exact known sites).
 27. analysis path: bipartite_spectrum, single_site_spectrum, one_site_rdm
     and see_variation of 4 test series (T 96) of the phase-24 model in
     float64 on the card against the CPU (within 1e-8), then in float32
     against the float64 CPU run (max |diff| printed), and the seconds
     see_variation takes.
 28. reference model path: the ECG200 model MPSTime.jl trained (from its
     .jld2 where h5py is installed, else from the .npz the port's save_mps
     wrote of it) on cuda in float64: train accuracy exactly 1.0, test
     accuracy 0.84 and the median imputation's MAE 0.1883971410956766 at
     rel 1e-8 (tests/test_itensor_import.py:28-29), else within one grid
     step of the CPU's imputation, both values printed.
 29. serialize path: a default fit on cuda, save_mps -> load_mps(device=
     "cuda"): trained_mps_equal(atol=0) and the same classify output.
 30. classifier path: MPSClassifier(nsweeps=10) (chi 25, d 5, f32) fit and
     score on cuda: K12m 240, no plain call, test accuracy >= ACC_FLOOR.
 31. padded path: fit_mps with MPSOptions(chi_max=15, d=4, pad_to=(25, 5))
     on cuda: cores (T, 25, 5, 25), bond dims <= 15, the state's weight on
     the padded site directions below PAD_DEAD_WEIGHT (the cores' raw share
     printed), K1 and K2 1900 each and no plain call (pad_to
     forces orth "qr"), its test accuracy beside the unpadded chi 15, d 4
     fit's.
 32. batched-fit path: fit_mps_batch of the 5 stratified folds of ECG200
     train at the default options on cuda (one fit_mps per fold) beside 5
     sequential fit_mps calls: the same K12m launches and the same bits,
     per-fold validation accuracy and both wall times.
 33. tune-evaluate path: evaluate on ECG200 train+test (N 200), 5 outer
     folds, MisclassificationRate, n_cvfolds=2, tuning_maxiters=3, chi_max
     (15, 5, 25), d [4, 5] (padded trials at (25, 5)), the default f32
     options: the 13 per-fold keys of the reference's results, the
     stratified partition law, the mean loss, the wall time and the K1 /
     K2 / K12m counts; then tune(fold_batch=True) with ImputationLoss
     (pms [0.2]), maxiters=2, on ECG200 train: each trial's folds one
     fit_mps_batch at the padded caps (K1 and K2, no plain call), then
     impute_windows on the card.
 34. loader path: the native UCR parser built from
     mpstime_tpu_torch/native/ucr_loader.cpp (fails if it does not build);
     trendysine TRAIN/TEST loaded ((90, 60), int64 labels 30/30/30); ECG200
     train written as UCR text with repr floats reads back bit for bit.
 35. three-class path: K12 and K12m against their plain versions at C=3,
     chi 25, d 5, N 90 over phase 3's grid and tolerances; fit_mps of
     trendysine at the default MPSOptions on cuda at init seeds 1234, 1
     and 2, then classify: K12m 160 a fit, no plain call, finite weights,
     mean train accuracy >= TS3_TRAIN_ACC_FLOOR; each seed's accuracies
     printed beside the CPU's.
 36. reference-engine path: the card's float64 gram_eigh fit (unfused,
     cuSOLVER) against naive_fit_mps / naive_predict on the JAX package's
     test problem (two_class_sines, N 24, chi 8, d 3, 4 sweeps): agreement
     >= NAIVE_AGREEMENT; at trendysine's width both accuracies, the naive
     engine's seconds and the agreement printed; training.full_sweep on
     cuda equals sweep_once bit for bit.
 37. profiling path: profile_trace around a two-sweep default ECG200 fit
     on cuda; the trace holds 48 k12m_cluster_kernel events and two
     mps/backward_bond and mps/forward_bond ranges, 24 K12m launches under
     each; their device ms printed.
Then the ptxas line (registers, static shared memory and spills of each
kernel), one JSON line of
per-kernel results (each kernel's launches from the fit that runs it; its
bound, the least time the card could take for the work of the timed call:
bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is
larger; a complex multiply-add counts 8 float32 operations and a complex64
value 8 bytes), the nvidia-smi line, and the final JSON status line.

Exits 2 without a result when no CUDA device is available or the package
is not beside this script.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 3e-5          # as tests/test_pallas_bond.py:73-82
CHAIN_ATOL = 1e-6                # K12m vs chained K12 launches
ACC_FLOOR = 0.85                 # f32 floor of the JAX hardware lane
QR_ACC_FLOOR = 0.80              # below the 0.84-0.91 seed spread of the ns route
DP_KLD_RTOL = 1e-3               # dp on one shard vs the fused fit, sweep 1
# two shards against one after 10 sweeps: the order of summing the gradient
# moves a first sweep's KLD by up to 2x (as rounding of the inputs does,
# tests/torch_dp_spread.py), and the fits meet again within 0.6 % by sweep
# 10 on 1, 2 and 4 shards (the same script's fits on the CPU)
DP2_FINAL_KLD_RTOL = 2e-2
# the complex (fourier) fit on two shards against one after 10 sweeps: the
# larger of 2 % and the CPU spread of `python tests/torch_dp_spread.py
# fourier`, complex64: the sweep-10 train KLD on 1, 2, 4 and 5 shards and
# under six float32-rounding-sized perturbations of the series spans 83.657
# to 91.159, 8.64 % of the one-shard fit's 86.843 (the fourier fit is
# still descending at sweep 10, so its first sweep's chaos has not died out)
CDP2_FINAL_KLD_RTOL = 8.7e-2
STREAM_RTOL, STREAM_ATOL = 2e-4, 1e-5   # tests/test_pallas_bond.py:559
DP2_BOND_ATOL = 1e-4             # one bond, shards (test_parallel.py:199-212)
FOURIER_ACC = (0.60, 0.92)       # the JAX lane's c64 band (tests/test_tpu_lane.py:134)
RITZ_ACC = (0.55, 0.95)          # the JAX lane's ritz band (tests/test_tpu_lane.py:182)
# K12cr against its plain version: the raw outputs at a wider bound, since
# Jacobi rounds on a random (untracked) Gram turn float32 rounding into
# rotations within near-degenerate pairs (a gauge: up to 7.3e-5 at 24
# rounds, q 3, in the CPU emulation of the kernel); the gauge invariants at
# RTOL / ATOL
RITZ_RTOL, RITZ_ATOL = 1e-3, 2e-4
SHAPE = dict(C=2, chi=25, d=5, N=100)
RITZ_SHAPE = dict(C=2, chi=64, d=5, N=100)
PEAK_BYTES_S = 3.35e12           # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12          # H100 SXM float32 outside the tensor cores
# a spin of the card (torch.cuda._sleep) of ~25 ms at its ~2 GHz clock:
# longer than the host takes to enqueue 200 wrapper calls of ~50 us
SPIN_CYCLES = 50_000_000
IMPUTE_DX = 1e-4                 # the JAX bench's guess grid (bench.py:186-214)
ENTROPY_ATOL = 1e-8              # analysis, float64 on the card vs the CPU
KERNEL_SRC = "mpstime_tpu_torch/csrc/bond_step.cu"
KERNEL_SRC_C = "mpstime_tpu_torch/csrc/bond_step_c.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bond_inputs(seed: int, Bb: int, C: int, chi: int, d: int, N: int):
    """Numpy-seeded operands of a block of Bb bonds, on the card."""
    from mpstime_tpu_torch.ops.decomp import warm_sketch_init
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return dict(
        A=t(rng.standard_normal((Bb, chi, d, chi))),
        center=t(rng.standard_normal((C, chi, d, chi))),
        envx=t(rng.standard_normal((Bb, N, chi))),
        env0=t(rng.standard_normal((N, chi))),
        ls0=t(rng.standard_normal(N)),
        opp=t(0.3 * rng.standard_normal(N)),
        phil=t(rng.uniform(-0.8, 0.8, (Bb, N, d))),
        phir=t(rng.uniform(-0.8, 0.8, (Bb, N, d))),
        y1h=t(np.eye(C)[rng.integers(0, C, N)]),
        w=t(np.full(N, 1.0 / N)),
        V0=torch.stack([warm_sketch_init(chi * d, chi, np.float32, "cuda")] * Bb),
    )


def bond_inputs_c(seed: int, Bb: int, C: int, chi: int, d: int, N: int):
    """Numpy-seeded complex64 operands of a block of Bb bonds, on the card:
    unit-modulus conjugated features, real log-scales, labels and weights."""
    from mpstime_tpu_torch.ops.decomp import warm_sketch_init
    rng = np.random.default_rng(seed)

    def c(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).cuda()

    def phi(*shape):
        z = np.exp(1j * rng.uniform(-np.pi, np.pi, shape)) / np.sqrt(d)
        return torch.from_numpy(z.astype(np.complex64)).cuda()

    def r(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    return dict(
        A=c(Bb, chi, d, chi), center=c(C, chi, d, chi), envx=c(Bb, N, chi),
        env0=c(N, chi), ls0=r(rng.standard_normal(N)),
        phil=phi(Bb, N, d), phir=phi(Bb, N, d),
        y1h=r(np.eye(C)[rng.integers(0, C, N)]), w=r(np.full(N, 1.0 / N)),
        V0=torch.stack([warm_sketch_init(chi * d, chi, np.complex64, "cuda")]
                       * Bb))


def ptxas_summary(log: str) -> str:
    """Registers, shared memory and spill bytes of each kernel entry in
    nvcc's -Xptxas -v output (dynamic shared memory is not in it)."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            kern = next((k for k in ("k12cr_kernel", "k12c_kernel",
                                     "k12m_cluster_kernel", "k12m_kernel",
                                     "k1_kernel", "k2_kernel",
                                     "k1a_kernel", "k1b_kernel",
                                     "k2_split_kernel", "k2_env_kernel",
                                     "k1_tail_kernel", "k2_env_rows_kernel",
                                     "k1_tail_grid_kernel",
                                     "k1_cluster_kernel",
                                     "k1b_cluster_kernel",
                                     "k1a_cluster_kernel",
                                     "k2_cluster_kernel",
                                     "k2_split_cluster_kernel")
                         if k in mangled),
                        mangled)
            name = f"{kern}<{'cfloat' if 'cfloat' in mangled else 'float'}>"
            if kern == "k2_env_rows_kernel":      # <T, Staged>
                name += " staged" if "Lb1E" in mangled else " unstaged"
            stores = loads = "0"
        elif name and "spill stores" in line:
            stores = line.split("bytes spill stores")[0].split(",")[-1].strip()
            loads = line.split("bytes spill loads")[0].split(",")[-1].strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            smem = (line.split("bytes smem")[0].split(",")[-1].strip()
                    if "bytes smem" in line else "0")
            out.append(f"{name} {regs} registers, {smem} B static smem, "
                       f"{stores} B spill stores, {loads} B spill loads")
            name = None
    return "; ".join(out) if out else "(library built earlier: no log)"


def k12_args(x, forward: bool, b: int = 0):
    le, re = (x["env0"], x["envx"][b]) if forward else (x["envx"][b], x["env0"])
    return (x["A"][b], x["center"], le, re, x["ls0"], x["phil"][b],
            x["phir"][b], x["y1h"], x["w"], x["V0"][b], 0.05, 1e-10)


def k12m_args(x):
    return (x["A"], x["center"], x["envx"], x["env0"], x["ls0"], x["phil"],
            x["phir"], x["y1h"], x["w"], x["V0"], 0.05, 1e-10)


def k12_k12m_vs_plain(bk, shape: dict, seed: int):
    """K12 over its variant grid (both directions x refresh q 1, 3, a
    frozen bond, KLD/MSE x TSGO/GD, a rank cap of 17) and K12m (Bb 8, 7 x
    both directions x refresh, frozen) against their plain versions on the
    card at ``shape``, each block also against Bb chained K12 launches.
    Returns ({"k12", "k12m"}: max |err|, {"k12", "k12m"}: cases)."""
    err = {"k12": 0.0, "k12m": 0.0}
    n_cases = {"k12": 0, "k12m": 0}
    k12_grid = []
    for forward in (False, True):
        for q in (1, 3):
            k12_grid.append((forward, True, q, "KLD", "TSGO", None))
        k12_grid.append((forward, False, 1, "KLD", "TSGO", None))
        for loss in ("KLD", "MSE"):
            for bbopt in ("TSGO", "GD"):
                k12_grid.append((forward, True, 1, loss, bbopt, None))
        k12_grid.append((forward, True, 1, "KLD", "TSGO", 17))
    for i, (forward, refresh, q, loss, bbopt, mr) in enumerate(k12_grid):
        x = bond_inputs(seed + i, 1, **shape)
        kw = dict(forward=forward, refresh=refresh, power_iters=q,
                  max_rank=mr, loss=loss, bbopt=bbopt,
                  opp_ls=x["opp"] if loss == "MSE" else None)
        name = (f"K12 C={shape['C']} {'fwd' if forward else 'bwd'} "
                f"refresh={refresh} q={q} {loss}/{bbopt} max_rank={mr}")
        got = bk.k12_cuda(*k12_args(x, forward), **kw)
        torch.cuda.synchronize()
        ref = bk.k12_plain(*k12_args(x, forward), **kw)
        err["k12"] = max(err["k12"], compare(name, got, ref, forward))
        n_cases["k12"] += 1
    for i, (Bb, forward, refresh) in enumerate(
            (Bb, f, r) for Bb in (8, 7) for f in (False, True)
            for r in (True, False)):
        x = bond_inputs(seed + 100 + i, Bb, **shape)
        kw = dict(forward=forward, refresh=refresh, power_iters=1)
        name = (f"K12m C={shape['C']} Bb={Bb} "
                f"{'fwd' if forward else 'bwd'} refresh={refresh}")
        got = bk.k12m_cuda(*k12m_args(x), **kw)
        torch.cuda.synchronize()
        ref = bk.k12m_plain(*k12m_args(x), **kw)
        err["k12m"] = max(err["k12m"], compare(name, got, ref, forward))
        # the block equals Bb chained single-bond launches
        center, env, ls, chain = x["center"], x["env0"], x["ls0"], []
        for b in range(Bb):
            le, re = (env, x["envx"][b]) if forward else (x["envx"][b], env)
            center, core, env, ls, Q = bk.k12_cuda(
                x["A"][b], center, le, re, ls, x["phil"][b], x["phir"][b],
                x["y1h"], x["w"], x["V0"][b], 0.05, 1e-10, **kw)
            chain.append((core, env, ls, Q))
        chained = (center,) + tuple(torch.stack(c) for c in zip(*chain))
        compare(name + " vs chained K12", got, chained, forward,
                atol=CHAIN_ATOL, rtol=0.0)
        n_cases["k12m"] += 1
    return err, n_cases


def k1_args(x, forward: bool):
    """K1's operands from bond_inputs: gls is the total log-scale."""
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], x["ls0"] + x["opp"], x["V0"][0], 0.05)


def k1c_args(x, forward: bool):
    """K1c's operands from bond_inputs_c (no log-scale: KLD only)."""
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], x["V0"][0], 0.05)


def k2_args(bk, x, forward: bool):
    """K2's operands: the plain K1's bond tensor and the QR of its Y."""
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    BT, Y = bk.k1_plain(*k1_args(x, forward), forward=forward)
    Q = torch.linalg.qr(Y).Q.contiguous()
    env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
    return BT, Q, env, x["ls0"], phi, 1e-10


def dp_args(seed: int, forward: bool, cplx: bool = False, shape=SHAPE):
    """One bond's operands at ``shape`` (the main-path shape) with unit
    environment rows, as a sweep hands them over: (A, center, le, re, phil,
    phir, y1h, w, gls, V0, env, env_ls, phi), env / phi the advancing
    side's; complex64 ones (gls, unread by the KLD gradient, the
    log-scales) when ``cplx``."""
    x = (bond_inputs_c if cplx else bond_inputs)(seed, 1, **shape)
    le, re = (x["env0"], x["envx"][0]) if forward else (x["envx"][0],
                                                       x["env0"])
    le, re = (t / t.norm(dim=1, keepdim=True) for t in (le, re))
    env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
    gls = x["ls0"] if cplx else x["ls0"] + x["opp"]
    return (x["A"][0], x["center"], le, re, x["phil"][0], x["phir"][0],
            x["y1h"], x["w"], gls, x["V0"][0], env, x["ls0"], phi)


def dp_step(step, mesh, args, forward: bool, **kw):
    """The dp bond step ``step`` (bond_step_dp, bond_step_c_dp) over
    ``mesh``'s shards of one bond's operands (``args`` as ``k12_args``'),
    its per-shard outputs joined."""
    n = len(mesh)
    out = step(mesh, [args[0]], [args[1]],
               *(list(t.chunk(n)) for t in args[2:9]), [args[9]], args[10],
               args[11], forward=forward, **kw)
    return (out[0][0], out[1][0], torch.cat(out[2]), torch.cat(out[3]),
            out[4][0])


def compare_all(name, got, ref, atol=ATOL, rtol=RTOL) -> float:
    """Max abs error over any outputs; raises past tolerance."""
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        check(g.shape == r.shape, f"{name}: output {i} shape "
              f"{tuple(g.shape)} != {tuple(r.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: output {i} not finite")
        diff = (g - r).abs()
        err = max(err, float(diff.max()))
        check(not bool((diff > atol + rtol * r.abs()).any()),
              f"{name}: output {i} max |diff| {float(diff.max()):.3e} beyond "
              f"atol {atol} + rtol {rtol}")
    return err


def kept(core, forward: bool):
    """Kept-direction mask of an emitted core ([.., m, k, b] backward,
    [.., a, i, m] forward)."""
    if forward:
        return (core != 0).any(dim=-2).any(dim=-2)
    return (core != 0).any(dim=-1).any(dim=-1)


def compare(name, got, ref, forward, atol=ATOL, rtol=RTOL) -> float:
    """Max abs error over the outputs (center, core, env, env_ls and, where
    given, Q); raises past tolerance or on a kept-rank mismatch."""
    err = 0.0
    for label, g, r in zip(("center", "core", "env", "env_ls", "Q"), got, ref):
        check(g.shape == r.shape, f"{name}: {label} shape {tuple(g.shape)} "
              f"!= {tuple(r.shape)}")
        check(bool(torch.isfinite(g).all()), f"{name}: {label} not finite")
        diff = (g - r).abs()
        err = max(err, float(diff.max()))
        bad = diff > atol + rtol * r.abs()
        check(not bool(bad.any()), f"{name}: {label} max |diff| "
              f"{float(diff.max()):.3e} beyond atol {atol} + rtol {rtol}")
    kg, kr = kept(got[1], forward), kept(ref[1], forward)
    check(bool(torch.equal(kg, kr)), f"{name}: kept ranks differ "
          f"({kg.sum(-1).tolist()} vs {kr.sum(-1).tolist()})")
    return err


def _units(cplx: bool):
    """(float32 operations per multiply-add, per elementwise operation,
    bytes per value) of the kernels' scalar type."""
    return (8, 4, 8) if cplx else (2, 1, 4)


def k1_work(C, chi, d, N, *, emit_y=True, q=1, qr=True, mse=False,
            cplx=False):
    """(float32 operations, bytes) of one K1 (K1c) call: its multiply-adds
    and elementwise operations; each operand read once and each result
    written once (labels, weights and log-scales are float32)."""
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
    """(float32 operations, bytes) of one K2 (K2c) call."""
    m, e, b = _units(cplx)
    P, K = chi * d, chi
    ops = (m * (C * P * K * P + N * K * P)
           + e * (2 * C * P * K + 3 * K * K + 2 * N * P + 2 * C * P * K
                  + 3 * N * K))
    reads = b * (C * P * P + P * K + N * chi + N * d) + 4 * N
    writes = b * (C * chi * d * chi + chi * d * chi + N * chi) + 4 * N
    return ops, reads + writes


def k1a_work(C, chi, d, N, *, mse=False, cplx=False):
    """(float32 operations, bytes) of one K1a (K1c-grad) call: the bond
    tensor, the batch products and the gradient; G [C, chi*d, d, chi]
    written once."""
    m, e, b = _units(cplx)
    P = chi * d
    ops = (m * (C * P * P * chi + 2 * C * N * P * P + N * C * P)
           + e * (2 * N * P + C * N * P + 3 * N * C))
    reads = b * (P * chi * (C + 1) + 2 * N * chi + 2 * N * d)
    reads += 4 * (N * C + N + (N if mse else 0))
    return ops, reads + b * C * P * P


def k1b_work(C, chi, d, *, emit_y=True, q=1, qr=False, cplx=False):
    """(float32 operations, bytes) of one K1b (K1c-update) call: the bond
    tensor, the step against G, the renormalisation and q power steps
    (Newton-Schulz polar unless qr)."""
    m, e, b = _units(cplx)
    P, K = chi * d, chi
    ops = m * C * P * P * chi + e * 6 * C * P * P
    if emit_y:
        ns = 0 if qr else (8 * (K * K * P + K ** 3 + P * K * K)
                           + 6 * (K * K * P + P * K * K))
        ops += q * (m * (2 * C * P * K * P + ns) + e * 6 * P * K)
    reads = b * (P * chi * (C + 1) + C * P * P + P * K)
    return ops, reads + b * (C * P * P + P * K)


def k1_tail_work(C, chi, d, *, q=1, qr=False, cplx=False):
    """(float32 operations, bytes) of one K1-tail (K1c-tail) call: q power
    steps of a stored bond tensor (Newton-Schulz polar unless qr); BT and V0
    read once, Y written once."""
    m, e, b = _units(cplx)
    P, K = chi * d, chi
    ns = 0 if qr else (8 * (K * K * P + K ** 3 + P * K * K)
                       + 6 * (K * K * P + P * K * K))
    ops = q * (m * (2 * C * P * K * P + ns) + e * 6 * P * K)
    return ops, b * (C * P * P + 2 * P * K)


def k2_split_work(C, chi, d, cplx=False):
    """(float32 operations, bytes) of one K2-split (K2c-split) call: the
    projection, the energies, the mask and the emission."""
    m, e, b = _units(cplx)
    P, K = chi * d, chi
    ops = m * C * P * K * P + e * (3 * C * P * K + 3 * K * K + 2 * P * K)
    reads = b * (C * P * P + P * K)
    return ops, reads + b * (C * chi * d * chi + chi * d * chi + P * K)


def k2_env_work(chi, d, N, cplx=False):
    """(float32 operations, bytes) of one K2-env (K2c-env) call: the batch
    factor, the advance through Qm and the per-sample renormalisation."""
    m, e, b = _units(cplx)
    P, K = chi * d, chi
    ops = m * N * K * P + e * (N * P + 3 * N * K)
    reads = b * (P * K + N * chi + N * d) + 4 * N
    return ops, reads + b * N * chi + 4 * N


def k12_work(C, chi, d, N, *, Bb=1, refresh=True, q=1, mse=False,
             cplx=False):
    """(float32 operations, bytes) of one K12 / K12m (K12c / K12mc) call
    over Bb bonds: K1 with the Newton-Schulz power step and K2, BT kept on
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


def k12cr_work(C, chi, d, N, *, refresh=True, q=1, rounds=6):
    """(float32 operations, bytes) of one K12cr call: K1c with the tri-Newton
    refresh (8 steps of X^H X and X T per power step), the Ritz Gram, the
    Jacobi rounds (two rows and columns of S and two columns of W per pair,
    and the re-hermitisation), the emission through W and the env advance;
    its operands and results are K12c's."""
    m, e, _ = _units(True)
    P, K = chi * d, chi
    ops, _ = k1_work(C, chi, d, N, emit_y=refresh, q=q, qr=True, cplx=True)
    if refresh:
        ops += q * 8 * (m * 2 * P * K * K + e * 3 * K * K)
    ops += m * (C * P * K * P + C * K * K * P)                # Gram
    ops += rounds * (m * 6 * K * K + e * 2 * K * K)           # Jacobi
    ops += m * (2 * P * K * K + C * P * K * K) + e * (P * K + K * K)
    ops += m * N * K * P + e * (N * P + 3 * N * K)            # env advance
    _, nbytes = k12_work(C, chi, d, N, refresh=refresh, q=q, cplx=True)
    return ops, nbytes


def bound(work):
    """(bound_ms, bound_by) of (operations, bytes)."""
    ops, nbytes = work
    t_ops, t_bytes = ops / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_queued_ms(fn, iters: int = 20) -> float:
    """Per-call device ms of ``fn``: one warm call, then ``iters`` calls
    enqueued while the card spins, so that they run back to back and the
    events time the card, not the host's wrapper calls between launches;
    fails if the host took longer to enqueue them than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    es.record()
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    e1.record()
    torch.cuda.synchronize()
    check(host_ms < es.elapsed_time(e0), f"queued timing: the host took "
          f"{host_ms:.2f} ms to enqueue, longer than the spin's "
          f"{es.elapsed_time(e0):.2f} ms")
    return e0.elapsed_time(e1) / iters


def time_turns(fused, split, rounds: int, iters: int, timer=None):
    """Per-call ms of two forms of one bond, timed in turns (fused, split,
    split, fused per round) on the same card by ``timer(fn, iters)``
    (default ``time_ms`` after one warm call): (fused times, split
    times)."""
    timer = timer or (lambda fn, n: time_ms(fn, n, warmup=1))
    tf, ts = [], []
    for _ in range(rounds):
        tf.append(timer(fused, iters))
        ts.append(timer(split, iters))
        ts.append(timer(split, iters))
        tf.append(timer(fused, iters))
    return tf, ts


def time_cluster(name, cluster_call, block_call, sized_call, sizes,
                 default: int, timer=None, what: str = "cluster") -> str:
    """Per-call ms of the cluster kernel ``name`` (``cluster_call``, at its
    default size ``default``) against its one-block kernel (``block_call``)
    in turns over 5 rounds, and at each cluster size in ``sizes``
    (``sized_call(n)``) over 5 interleaved rounds, by ``timer(fn, iters)``
    (default ``time_ms``); fails unless the cluster beats one block and the
    default is the fastest size within the spread of their rounds.  Returns
    the report."""
    t_new, t_one = time_turns(cluster_call, block_call, rounds=5, iters=20,
                              timer=timer)
    # each size timed in 5 interleaved rounds: the sizes' medians and
    # spreads decide the default, not one timing each
    rounds = {n: [] for n in sizes}
    for _ in range(5):
        for n in sizes:
            rounds[n].append((timer or time_ms)(lambda: sized_call(n), 20))
    by_size = {n: statistics.median(t) for n, t in rounds.items()}
    new_ms, one_ms = statistics.median(t_new), statistics.median(t_one)
    check(new_ms < one_ms, f"{name} ({what} {default}) {new_ms:.3f} ms is "
          f"not below its one-block kernel ({one_ms:.3f} ms)")
    # the default must be the fastest size, within the two sizes' spread
    # over their rounds
    fast, mine = min(by_size, key=by_size.get), rounds[default]
    spread = max(max(mine) - min(mine), max(rounds[fast]) - min(rounds[fast]))
    check(by_size[default] - by_size[fast] <= spread,
          f"{name}: the default {what} of {default} "
          f"({by_size[default]:.4f} ms) is slower than {fast} "
          f"({by_size[fast]:.4f} ms) by more than the spread {spread:.4f} ms")
    return (f"median {new_ms:.4f} ({min(t_new):.4f}-{max(t_new):.4f}) ms vs "
            f"one block {one_ms:.4f} ({min(t_one):.4f}-{max(t_one):.4f}) ms "
            f"in turns ({one_ms / new_ms:.2f}x); by {what} size, median "
            "(min-max) of 5 interleaved rounds " +
            ", ".join(f"{n}: {by_size[n]:.4f} ({min(t):.4f}-{max(t):.4f})"
                      for n, t in rounds.items()) + f" ms (fastest {fast})")


def split_wins_from(timed):
    """The smallest chi from which the split form beats the fused one by
    more than the run-to-run spread (the medians apart by more than either
    form's max - min over its turns) at every larger measured chi, else
    None."""
    chi_min = None
    for chi in sorted(timed, reverse=True):
        tf, ts = timed[chi]
        spread = max(max(tf) - min(tf), max(ts) - min(ts))
        if statistics.median(tf) - statistics.median(ts) <= spread:
            break
        chi_min = chi
    return chi_min


def ritz_invariants(out, forward: bool):
    """The gauge invariants of a ritz bond step's outputs (tests/
    test_pallas_bond_c.py:388-432): the reconstructed two-site tensor, the
    environment contracted against conj(core), the log-scales and the
    projector of the cache."""
    center, core, env, ls, Q = out
    if forward:
        rec = torch.einsum("aim,cmkb->caikb", core, center)
        inv = torch.einsum("nm,akm->nak", env, core.conj())
    else:
        rec = torch.einsum("caim,mkb->caikb", center, core)
        inv = torch.einsum("nm,mkb->nkb", env, core.conj())
    return rec, inv, ls, Q @ Q.conj().T


def tie_break_inputs():
    """The degenerate-spectrum oracle of tests/test_pallas_bond.py:144-179
    as a whole bond step: BT[0, i, 0, j] = sqrt(w_j) delta_ij with w =
    [4, 2, 2, 2, 1, 0.5], Q selecting the k=0 block (frozen bond, eta 0),
    so the projected energies tie and the cutoff boundary falls inside the
    tie group.  The stable order keeps exactly directions 0..2."""
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
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    cutoff = float(np.float32(4.5 / w.sum()))
    return (t(A), t(center), t(env), t(env), t(np.zeros(N, np.float32)),
            t(phi), t(phi), t(np.ones((N, C), np.float32)),
            t(np.full(N, 1.0 / N, np.float32)), t(V0), 0.0, cutoff)


#: The outputs of K1 and K1b (K1c, K1c-update), for equal()'s labels.
BT_Y = ("BT", "Y")


def equal(name, got, ref, labels=("center", "core", "env", "env_ls", "Q")):
    """Bit-for-bit equality of a cluster kernel's outputs ``got`` with its
    one-block kernel's ``ref``, output by output (named by ``labels``)."""
    for label, g, r in zip(labels, got, ref):
        check(bool(torch.isfinite(g).all()), f"{name}: {label} not finite")
        check(bool(torch.equal(g, r)), f"{name}: {label} differs, max "
              f"|diff| {float((g - r).abs().max()):.3e}")


def k12m_raw(x, opp_ls=None):
    """K12m's operands from bond_inputs in the launch helpers' order
    (bond_kernels._k12m, bond_kernels_c._k12mc)."""
    a = k12m_args(x)
    return a[:5] + (opp_ls,) + a[5:]


def refusal(name, wrapper, raw) -> str:
    """How kernel ``name`` refuses a cluster of 32 blocks: ``wrapper`` (the
    public call, or the checked cluster launch where the wrapper takes no
    size) must raise ValueError and ``raw`` (the same launch past that
    check) the card's RuntimeError, with no launch counted; returns what
    each said."""
    from mpstime_tpu_torch.ops import bond_kernels as bk
    before = dict(bk.LAUNCHES)
    try:
        wrapper()
        said = "wrapper launched"
    except ValueError as exc:
        said = f"wrapper ValueError ({exc})"
    try:
        raw()
        torch.cuda.synchronize()
        said += "; card launched"
    except RuntimeError as exc:
        said += f"; card RuntimeError ({str(exc).split(': ', 1)[-1]})"
    check("launched" not in said, f"{name}: a cluster of 32 blocks "
          f"launched ({said})")
    check(dict(bk.LAUNCHES) == before, f"{name}: a refused cluster launched "
          f"a kernel: {bk.LAUNCHES} vs {before}")
    return said


def cluster_phase(card: str) -> None:
    """K12c and K12cr, one bond over a thread-block cluster, against the
    one-block designs bit for bit: K12c against the one-block K12mc at
    Bb = 1 (k12m_kernel) over the complex grid at the main-path shape and
    at chi 128 and 192; K12cr equal across cluster sizes over its ritz grid
    at chi 64 and chi 8; a cluster the card refuses raises; the occupancy of
    clusters; per-call ms of K12c and the one-block K12mc at Bb = 1 in turns
    and of K12cr at each cluster size."""
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    sizes = (1, 2, 4, 8, 16)
    occ = {(ritz, n): bkc.cluster_occupancy("k12cr" if ritz else "k12c", n,
                                            64 if ritz else 25)
           for ritz in (False, True) for n in sizes}
    check(occ[(False, bkc.CLUSTER)] >= 1 and occ[(True, bkc.CLUSTER)] >= 1,
          f"the chosen cluster of {bkc.CLUSTER} blocks cannot be placed: "
          f"{occ}")
    print(f"[k12c-k12cr-cluster] cluster size {bkc.CLUSTER} (blocks of 512 "
          "threads); clusters the card holds at once (cudaOccupancyMax"
          "ActiveClusters), K12c at chi 25: " + ", ".join(
              f"{n}: {occ[(False, n)]}" for n in sizes) + "; K12cr at chi 64: "
          + ", ".join(f"{n}: {occ[(True, n)]}" for n in sizes)
          + f" ({card})", flush=True)

    def k12mc_one(x, **kw):
        out = bkc.k12mc_block_cuda(*k12m_args(x), **kw)
        return (out[0],) + tuple(t[0] for t in out[1:])

    n_k12c = 0
    grid = [(f, r, q, mr) for f in (False, True)
            for r, q, mr in ((True, 1, None), (True, 3, None),
                             (False, 1, None), (True, 3, 17))]
    cases = [(SHAPE, g, 600 + i) for i, g in enumerate(grid)]
    cases += [(dict(SHAPE, chi=chi), (f, True, 3, None), 2100 + chi + f)
              for chi in (128, 192) for f in (False, True)]
    for shape, (forward, refresh, q, mr), seed in cases:
        x = bond_inputs_c(seed, 1, **shape)
        kw = dict(forward=forward, refresh=refresh, power_iters=q,
                  max_rank=mr)
        got = bkc.k12c_cuda(*k12_args(x, forward), **kw)
        torch.cuda.synchronize()
        equal(f"K12c chi={shape['chi']} {kw} vs K12mc Bb=1", got,
              k12mc_one(x, **kw))
        n_k12c += 1
    x = bond_inputs_c(17, 1, **SHAPE)
    refused = refusal(
        "K12c",
        lambda: bkc.k12c_cuda(*k12_args(x, False), forward=False,
                              cluster=32),
        lambda: bkc._k12mc("mpst_k12c_launch", (32,), *k12m_raw(x),
                           forward=False, refresh=True, power_iters=1,
                           max_rank=None))
    print(f"[k12c-k12cr-cluster] K12c (cluster {bkc.CLUSTER}) vs the "
          f"one-block K12mc at Bb = 1, {n_k12c} cases (the complex grid at "
          "chi 25, q 3 at chi 128 and 192, both directions): torch.equal on "
          "all five "
          f"outputs; a cluster of 32 blocks raises ({refused})", flush=True)

    ritz_grid = [(f, r, q, n, mr) for f in (False, True)
                 for r, q, n, mr in ((True, 1, 6, None), (False, 1, 6, None),
                                     (True, 3, 24, None), (True, 1, 6, 17))]
    placed = [n for n in sizes if occ[(True, n)] >= 1]
    n_k12cr = 0
    for shape, seed0 in ((RITZ_SHAPE, 1000), (dict(C=2, chi=8, d=3, N=16),
                                              1100)):
        for i, (forward, refresh, q, rounds, mr) in enumerate(ritz_grid):
            x = bond_inputs_c(seed0 + i, 1, **shape)
            kw = dict(forward=forward, refresh=refresh, power_iters=q,
                      rounds=rounds, max_rank=mr)
            ref = bkc.k12cr_cuda(*k12_args(x, forward), cluster=placed[0],
                                 **kw)
            for n in placed[1:]:
                equal(f"K12cr chi={shape['chi']} {kw} cluster {n} vs "
                      f"{placed[0]}", bkc.k12cr_cuda(*k12_args(x, forward),
                                                     cluster=n, **kw), ref)
            n_k12cr += 1
    print(f"[k12c-k12cr-cluster] K12cr equal across cluster sizes {placed}, "
          f"{n_k12cr} cases (the ritz grid at chi 64 and chi 8): torch.equal "
          "on all five outputs", flush=True)

    xc = bond_inputs_c(17, 1, **SHAPE)
    kw3 = dict(forward=False, refresh=True, power_iters=3)
    t_new, t_one = time_turns(
        lambda: bkc.k12c_cuda(*k12_args(xc, False), **kw3),
        lambda: k12mc_one(xc, **kw3), rounds=3, iters=20)
    xr = bond_inputs_c(19, 1, **RITZ_SHAPE)
    kwr = dict(forward=False, refresh=True, power_iters=1, rounds=6)
    t_ritz = {n: time_ms(lambda: bkc.k12cr_cuda(*k12_args(xr, False),
                                                cluster=n, **kwr))
              for n in placed}
    k12c_ms, one_ms = statistics.median(t_new), statistics.median(t_one)
    check(k12c_ms < one_ms, f"K12c {k12c_ms:.3f} ms is not below the "
          f"one-block K12mc at Bb = 1 ({one_ms:.3f} ms)")
    check(t_ritz[bkc.CLUSTER] < t_ritz[1], f"K12cr at cluster "
          f"{bkc.CLUSTER} {t_ritz[bkc.CLUSTER]:.3f} ms is not below cluster "
          f"1 ({t_ritz[1]:.3f} ms)")
    print(f"[k12c-k12cr-cluster] per call, a backward refresh bond: K12c "
          f"(chi 25, q 3, cluster {bkc.CLUSTER}) "
          f"{[round(t, 4) for t in t_new]} ms vs the one-block K12mc at Bb "
          f"= 1 {[round(t, 4) for t in t_one]} ms, in turns (median "
          f"{k12c_ms:.4f} vs {one_ms:.4f}, {one_ms / k12c_ms:.2f}x); "
          "K12cr (chi 64, q 1, 6 rounds) by cluster size: " + ", ".join(
              f"{n}: {t:.4f} ms" for n, t in t_ritz.items())
          + f" ({card})", flush=True)
    # K12c's own kernel against the cluster K12mc at Bb = 1 (the same bits):
    # both through the same launch helper, in turns
    same = []
    for label, kw in (("frozen", dict(refresh=False, power_iters=1)),
                      ("q 1", dict(refresh=True, power_iters=1)),
                      ("q 3", dict(refresh=True, power_iters=3))):
        kw = dict(kw, forward=False, max_rank=None)
        ref = bkc._k12mc("mpst_k12c_launch", (bkc.CLUSTER,), *k12m_raw(xc),
                         **kw)
        equal(f"K12c {label} vs the cluster K12mc at Bb = 1",
              bkc._k12mc_cluster(bkc.CLUSTER, *k12m_raw(xc), **kw), ref)
        t_c, t_m = time_turns(
            lambda: bkc._k12mc("mpst_k12c_launch", (bkc.CLUSTER,),
                               *k12m_raw(xc), **kw),
            lambda: bkc._k12mc_cluster(bkc.CLUSTER, *k12m_raw(xc), **kw),
            rounds=5, iters=20)
        same.append(f"{label} {statistics.median(t_c):.4f} "
                    f"({min(t_c):.4f}-{max(t_c):.4f}) vs "
                    f"{statistics.median(t_m):.4f} "
                    f"({min(t_m):.4f}-{max(t_m):.4f})")
    print(f"[k12c-k12cr-cluster] K12c (k12c_kernel) vs the cluster K12mc at "
          f"Bb = 1 (k12m_cluster_kernel), equal bits, a backward bond at chi "
          f"25, cluster {bkc.CLUSTER}, median (min-max) of 10 in turns: "
          + "; ".join(same) + f" ms ({card})", flush=True)
    # where a bond's time goes: the frozen bond, then each power step (K12c)
    # or the Jacobi rounds and the tri-Newton step (K12cr)
    parts = {
        f"K12c {label}": time_ms(lambda: bkc.k12c_cuda(
            *k12_args(xc, False), forward=False, **kw))
        for label, kw in (("frozen", dict(refresh=False)),
                          ("q 1", dict(power_iters=1)),
                          ("q 3", dict(power_iters=3)))}
    parts.update({
        f"K12cr {label}": time_ms(lambda: bkc.k12cr_cuda(
            *k12_args(xr, False), forward=False, **kw))
        for label, kw in (("frozen, 0 rounds", dict(refresh=False, rounds=0)),
                          ("frozen, 6 rounds", dict(refresh=False, rounds=6)),
                          ("q 1, 6 rounds", dict(rounds=6)))})
    print(f"[k12c-k12cr-cluster] a backward bond by part (cluster "
          f"{bkc.CLUSTER}): " + "; ".join(f"{k} {v:.4f} ms"
                                          for k, v in parts.items())
          + f" ({card})", flush=True)


def k1c_cluster_phase(card: str, ptxas: str) -> None:
    """K1c and K1c-update, one complex bond update over a thread-block
    cluster, against their one-block kernels bit for bit (both outputs) over
    both directions x (emit_y, q, orth) at the main-path shape and q 3 at
    chi 128, and across every cluster size the card places; a cluster of
    32 blocks refused by the wrapper and, past it, by the card, with
    nothing launched; the occupancy of clusters; their ptxas entries;
    per-call ms of each cluster kernel and its one-block kernel in turns,
    and by cluster size."""
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    tag = "[k1c-k1c-update-cluster]"
    sizes = (1, 2, 4, 8, 16)
    names = {"k1c": "K1c", "k1c_update": "K1c-update"}
    cluster_fn = {"k1c": bkc.k1c_cuda, "k1c_update": bkc.k1c_update_cuda}
    block_fn = {"k1c": bkc.k1c_block_cuda,
                "k1c_update": bkc.k1c_update_block_cuda}
    default = {"k1c": bkc.K1C_CLUSTER, "k1c_update": bkc.K1C_UPDATE_CLUSTER}
    occ = {(k, n): bkc.cluster_occupancy(k, n, SHAPE["chi"])
           for k in names for n in sizes}
    placed = {k: [n for n in sizes if occ[(k, n)] >= 1] for k in names}
    for k in names:
        check(default[k] in placed[k], f"{names[k]}: the chosen cluster of "
              f"{default[k]} blocks cannot be placed: {occ}")
    print(f"{tag} cluster sizes K1c {bkc.K1C_CLUSTER}, K1c-update "
          f"{bkc.K1C_UPDATE_CLUSTER} (blocks of 512 threads); clusters the "
          "card holds at once (cudaOccupancyMaxActiveClusters) at chi 25, "
          + "; ".join(f"{names[k]}: " + ", ".join(
              f"{n}: {occ[(k, n)]}" for n in sizes) for k in names)
          + f" ({card})", flush=True)
    if "no log" not in ptxas:
        mine = [e for e in ptxas.split("; ")
                if e.startswith(("k1_cluster_kernel<cfloat>",
                                 "k1b_cluster_kernel<cfloat>"))]
        check(len(mine) == 2, f"ptxas: no entry for the complex cluster "
              f"kernels ({ptxas})")
        print(f"{tag} ptxas: " + "; ".join(mine), flush=True)

    def operands(key, seed, shape, forward):
        """K1c's operands, or K1c-update's with K1c-grad's gradient."""
        if key == "k1c":
            return k1c_args(bond_inputs_c(seed, 1, **shape), forward)
        a = dp_args(seed, forward, cplx=True, shape=shape)
        return (a[0], a[1], bkc.k1c_grad_cuda(*a[:9], forward=forward),
                a[9], 0.05)

    grid = [(f, e, q, o) for f in (False, True)
            for e, q, o in ((True, 1, "qr"), (True, 3, "qr"),
                            (False, 1, "qr"), (True, 1, "ns"),
                            (True, 3, "ns"))]
    cases = [(SHAPE, g) for g in grid]
    cases += [(dict(SHAPE, chi=128), (f, True, 3, o)) for f in (False, True)
              for o in ("qr", "ns")]
    for key, name in names.items():
        for i, (shape, (forward, emit_y, q, orth)) in enumerate(cases):
            args = operands(key, 2200 + i, shape, forward)
            kw = dict(forward=forward, emit_y=emit_y, power_iters=q,
                      orth=orth)
            ref = block_fn[key](*args, **kw)
            label = f"{name} chi={shape['chi']} {kw}"
            equal(f"{label} vs one block", cluster_fn[key](*args, **kw), ref,
                  BT_Y)
            for n in placed[key]:
                equal(f"{label} cluster {n} vs one block",
                      cluster_fn[key](*args, cluster=n, **kw), ref, BT_Y)
    torch.cuda.synchronize()
    refused = {}
    for key, name in names.items():
        args = operands(key, 2290, SHAPE, False)
        # past the wrapper's check, the card refuses the launch itself
        raw = bkc._k1c if key == "k1c" else bkc._k1c_update
        entry = ("mpst_k1c_cluster_launch" if key == "k1c"
                 else "mpst_k1c_update_cluster_launch")
        refused[name] = refusal(
            name, lambda: cluster_fn[key](*args, forward=False, cluster=32),
            lambda: raw(entry, (32,), *args, forward=False, emit_y=True,
                        power_iters=1, orth="qr"))
        # the refusal leaves no error behind for the next launch
        equal(f"{name} after a refusal", cluster_fn[key](*args,
                                                         forward=False),
              block_fn[key](*args, forward=False), BT_Y)
    print(f"{tag} cluster vs one block, {len(cases)} cases each (both "
          "directions x (emit_y, q, orth) in (1, 1, qr), (1, 3, qr), (0, 1, "
          "qr), (1, 1, ns), (1, 3, ns) at chi 25; q 3, qr and ns at chi 128; "
          "K1c-update's gradient from K1c-grad): torch.equal on BT and Y "
          "for K1c and K1c-update, at the default cluster and at every size "
          f"placed ({placed['k1c']}, {placed['k1c_update']}); a cluster of "
          "32 blocks raises, nothing launched: " + "; ".join(
              f"{k}: {v}" for k, v in refused.items()), flush=True)

    x = bond_inputs_c(17, 1, **SHAPE)
    xd = dp_args(22, False, cplx=True)
    G = bkc.k1c_grad_cuda(*xd[:9], forward=False)
    timed = {"k1c": (k1c_args(x, False), dict(forward=False, power_iters=3)),
             "k1c_update": ((xd[0], xd[1], G, xd[9], 0.05),
                            dict(forward=False, orth="ns", power_iters=3))}
    lines = []
    for key, (args, kw) in timed.items():
        t_new, t_one = time_turns(lambda: cluster_fn[key](*args, **kw),
                                  lambda: block_fn[key](*args, **kw),
                                  rounds=3, iters=20)
        # each size timed in 5 interleaved rounds: the sizes' medians and
        # spreads decide the default, not one timing each
        rounds = {n: [] for n in placed[key]}
        for _ in range(5):
            for n in placed[key]:
                rounds[n].append(time_ms(lambda: cluster_fn[key](
                    *args, cluster=n, **kw)))
        by_size = {n: statistics.median(t) for n, t in rounds.items()}
        new_ms, one_ms = statistics.median(t_new), statistics.median(t_one)
        check(new_ms < one_ms, f"{names[key]} (cluster {default[key]}) "
              f"{new_ms:.3f} ms is not below its one-block kernel "
              f"({one_ms:.3f} ms)")
        lines.append(
            f"{names[key]} ({kw.get('orth', 'qr')}, q 3, cluster "
            f"{default[key]}) {[round(t, 4) for t in t_new]} ms vs one block "
            f"{[round(t, 4) for t in t_one]} ms in turns (median "
            f"{new_ms:.4f} vs {one_ms:.4f}, {one_ms / new_ms:.2f}x); by "
            "cluster size, median (min-max) of 5 interleaved rounds " +
            ", ".join(f"{n}: {by_size[n]:.4f} ({min(t):.4f}-{max(t):.4f})"
                      for n, t in rounds.items())
            + f" ms (fastest {min(by_size, key=by_size.get)})")
    print(f"{tag} per call, a backward refresh bond at chi 25: "
          + "; ".join(lines) + f" ({card})", flush=True)


def k12m_cluster_phase(card: str, ptxas: str) -> None:
    """K12, K12m and K12mc, a block of bonds over a thread-block cluster,
    against their one-block kernels bit for bit (all five outputs) over
    their grids, at the default cluster and at every size the card places;
    a cluster of 32 blocks refused by the wrapper and, past it, by the
    card; the occupancy of clusters; their ptxas entries; per-call ms of
    each against its one-block kernel in turns, and by cluster size."""
    from mpstime_tpu_torch.ops import bond_kernels as bk
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    tag = "[k12m-k12mc-cluster]"
    sizes = (1, 2, 4, 8, 16)
    occ = {(k, n): bkc.cluster_occupancy(k, n, SHAPE["chi"])
           for k in ("k12m", "k12mc") for n in sizes}
    placed = {k: [n for n in sizes if occ[(k, n)] >= 1]
              for k in ("k12m", "k12mc")}
    default = {"K12": bk.K12M_CLUSTER, "K12m": bk.K12M_CLUSTER,
               "K12mc": bkc.K12MC_CLUSTER}
    for name, n in default.items():
        kern = "k12mc" if name == "K12mc" else "k12m"
        check(n in placed[kern], f"{name}: the chosen cluster of {n} blocks "
              f"cannot be placed: {occ}")
    print(f"{tag} cluster sizes K12 and K12m {bk.K12M_CLUSTER}, K12mc "
          f"{bkc.K12MC_CLUSTER} (blocks of 512 "
          "threads); clusters the card holds at once (cudaOccupancyMax"
          "ActiveClusters) at chi 25, " + "; ".join(
              f"{k}: " + ", ".join(f"{n}: {occ[(k, n)]}" for n in sizes)
              for k in ("k12m", "k12mc")) + f" ({card})", flush=True)
    if "no log" not in ptxas:
        mine = [e for e in ptxas.split("; ")
                if e.startswith("k12m_cluster_kernel")]
        check(len(mine) == 2, f"ptxas: no entry for the cluster K12m "
              f"({ptxas})")
        print(f"{tag} ptxas: " + "; ".join(mine), flush=True)

    def first(out):
        return (out[0],) + tuple(t[0] for t in out[1:])

    def real_at(n, raw, **kw):
        """K12m's launch over a cluster of n blocks, past the wrappers (a
        bond's outputs at Bb = 1, as K12's)."""
        kw = dict(dict(refresh=True, power_iters=1, max_rank=None,
                       loss="KLD", bbopt="TSGO"), **kw)
        out = bk._k12m_cluster(n, *raw, **kw)
        return first(out) if raw[0].shape[0] == 1 else out

    def run_real(x, n=None, **kw):
        """K12 (Bb = 1) or K12m through its wrapper, or over a cluster of n
        blocks."""
        if n is not None:
            return real_at(n, k12m_raw(x), **kw)
        if x["A"].shape[0] == 1:
            return bk.k12_cuda(*k12_args(x, kw["forward"]), **kw)
        return bk.k12m_cuda(*k12m_args(x), **kw)

    # (inputs, kwargs, cluster wrapper, one-block wrapper, one-block output
    # as the wrapper's)
    cases = []
    real_grid = [(Bb, f, r, q, "TSGO", None) for Bb in (1, 2, 4, 8)
                 for f in (False, True)
                 for r, q in ((True, 1), (True, 3), (False, 1))]
    real_grid += [(Bb, f, True, 1, "GD", None) for Bb in (1, 8)
                  for f in (False, True)]
    real_grid += [(Bb, f, True, 3, "TSGO", 17) for Bb in (1, 8)
                  for f in (False, True)]
    for i, (Bb, f, r, q, bbopt, mr) in enumerate(real_grid):
        cases.append(("real", bond_inputs(3000 + i, Bb, **SHAPE),
                      dict(forward=f, refresh=r, power_iters=q, bbopt=bbopt,
                           max_rank=mr)))
    for f in (False, True):
        cases.append(("real", bond_inputs(3100 + f, 2, **dict(SHAPE, chi=128)),
                      dict(forward=f, refresh=True, power_iters=3)))
    cplx_grid = [(Bb, f, r, q, None) for Bb in (1, 2, 3, 4)
                 for f in (False, True)
                 for r, q in ((True, 1), (True, 3), (False, 1))]
    cplx_grid += [(4, f, True, 3, 17) for f in (False, True)]
    for i, (Bb, f, r, q, mr) in enumerate(cplx_grid):
        cases.append(("cplx", bond_inputs_c(3200 + i, Bb, **SHAPE),
                      dict(forward=f, refresh=r, power_iters=q, max_rank=mr)))
    for f in (False, True):
        cases.append(("cplx", bond_inputs_c(3300 + f, 2,
                                            **dict(SHAPE, chi=128)),
                      dict(forward=f, refresh=True, power_iters=3)))
    n_cases = {"real": 0, "cplx": 0}
    for kind, x, kw in cases:
        Bb, chi = x["A"].shape[0], x["A"].shape[1]
        label = f"{kind} Bb={Bb} chi={chi} {kw}"
        if kind == "real":
            ref = bk.k12m_block_cuda(*k12m_args(x), **kw)
            ref = first(ref) if Bb == 1 else ref

            def run(n=None):
                return run_real(x, n, **kw)
        else:
            ref = bkc.k12mc_block_cuda(*k12m_args(x), **kw)

            def run(n=None):
                if n is None:
                    return bkc.k12mc_cuda(*k12m_args(x), **kw)
                return bkc._k12mc_cluster(n, *k12m_raw(x), **dict(
                    dict(refresh=True, power_iters=1, max_rank=None), **kw))
        equal(f"{label} vs one block", run(), ref)
        for n in placed["k12mc" if kind == "cplx" else "k12m"]:
            equal(f"{label} cluster {n} vs one block", run(n), ref)
        n_cases[kind] += 1
    # MSE (K12 only) and the cutoff tie-break, at every size placed
    n_mse = 0
    for i, (f, bbopt) in enumerate((f, o) for f in (False, True)
                                   for o in ("TSGO", "GD")):
        x = bond_inputs(3400 + i, 1, **SHAPE)
        kw = dict(forward=f, loss="MSE", bbopt=bbopt)
        ref = first(bk.k12m_block_cuda(*k12m_args(x), opp_ls=x["opp"], **kw))
        equal(f"K12 MSE {kw} vs one block",
              bk.k12_cuda(*k12_args(x, f), opp_ls=x["opp"], **kw), ref)
        for n in placed["k12m"]:
            equal(f"K12 MSE {kw} cluster {n} vs one block",
                  real_at(n, k12m_raw(x, x["opp"]), **kw), ref)
        n_mse += 1
    tb = tie_break_inputs()
    A, center, le, re, ls, phil, phir, y1h, w, V0, eta, cutoff = tb
    kw = dict(forward=False, refresh=False)
    ref = first(bk.k12m_block_cuda(A[None], center, le[None], re, ls,
                                   phil[None], phir[None], y1h, w, V0[None],
                                   eta, cutoff, **kw))
    for n in [None] + placed["k12m"]:
        got = (bk.k12_cuda(*tb, **kw) if n is None else real_at(
            n, (A[None], center, le[None], re, ls, None, phil[None],
                phir[None], y1h, w, V0[None], eta, cutoff), **kw))
        equal(f"K12 tie-break cluster {n} vs one block", got, ref)
        kept_dirs = kept(got[1], False).tolist()
        check(kept_dirs == [True] * 3 + [False] * 3,
              f"K12 tie-break cluster {n} kept {kept_dirs}")
    torch.cuda.synchronize()
    refused = {}
    x1 = bond_inputs(3502, 1, **SHAPE)
    xr, xc = bond_inputs(3500, 4, **SHAPE), bond_inputs_c(3501, 4, **SHAPE)
    raw_kw = dict(forward=False, refresh=True, power_iters=1, max_rank=None)
    for name, wrapper, raw, after, block in (
            ("K12",
             lambda: real_at(32, k12m_raw(x1), forward=False),
             lambda: bk._k12m("mpst_k12m_cluster_launch", (32,),
                              *k12m_raw(x1), loss="KLD", bbopt="TSGO",
                              **raw_kw),
             lambda: bk.k12_cuda(*k12_args(x1, False), forward=False),
             lambda: first(bk.k12m_block_cuda(*k12m_args(x1),
                                              forward=False))),
            ("K12m",
             lambda: real_at(32, k12m_raw(xr), forward=False),
             lambda: bk._k12m("mpst_k12m_cluster_launch", (32,),
                              *k12m_raw(xr), loss="KLD", bbopt="TSGO",
                              **raw_kw),
             lambda: bk.k12m_cuda(*k12m_args(xr), forward=False),
             lambda: bk.k12m_block_cuda(*k12m_args(xr), forward=False)),
            ("K12mc",
             lambda: bkc._k12mc_cluster(32, *k12m_raw(xc), **raw_kw),
             lambda: bkc._k12mc("mpst_k12mc_cluster_launch", (32,),
                                *k12m_raw(xc), **raw_kw),
             lambda: bkc.k12mc_cuda(*k12m_args(xc), forward=False),
             lambda: bkc.k12mc_block_cuda(*k12m_args(xc), forward=False))):
        refused[name] = refusal(name, wrapper, raw)
        # the refusal leaves no error behind for the next launch
        equal(f"{name} after a refusal", after(), block())
    print(f"{tag} cluster vs one block, torch.equal on all five outputs at "
          f"the default cluster and at every size placed ({placed['k12m']}, "
          f"{placed['k12mc']}): K12 and K12m {n_cases['real']} cases (Bb 1, "
          "2, 4, 8 x both directions x (refresh q 1, refresh q 3, frozen), "
          "TSGO; GD and max_rank 17 at Bb 1 and 8; q 3 at chi 128, Bb 2), "
          f"K12 MSE {n_mse} cases (TSGO, GD), the tie-break (kept directions "
          f"0..2); K12mc {n_cases['cplx']} cases (Bb 1-4 x both directions x "
          "(refresh q 1, refresh q 3, frozen); max_rank 17 at Bb 4; q 3 at "
          "chi 128, Bb 2); a cluster of 32 blocks raises, nothing launched: "
          + "; ".join(f"{k}: {v}" for k, v in refused.items()), flush=True)

    x1, x8 = bond_inputs(7, 1, **SHAPE), bond_inputs(8, 8, **SHAPE)
    xc4 = bond_inputs_c(18, 4, **SHAPE)
    kw1 = dict(forward=False, refresh=True, power_iters=1)
    kwf = dict(forward=False, refresh=False, power_iters=1)
    # (the wrapper, the launch at cluster size n, the one-block kernel)
    timed = {
        "K12": (lambda: bk.k12_cuda(*k12_args(x1, False), **kw1),
                lambda n: real_at(n, k12m_raw(x1), **kw1),
                lambda: bk.k12m_block_cuda(*k12m_args(x1), **kw1),
                "k12m", "a backward refresh bond, q 1"),
        "K12m": (lambda: bk.k12m_cuda(*k12m_args(x8), **kw1),
                 lambda n: real_at(n, k12m_raw(x8), **kw1),
                 lambda: bk.k12m_block_cuda(*k12m_args(x8), **kw1),
                 "k12m", "an 8-bond backward refresh block, q 1"),
        "K12mc": (lambda: bkc.k12mc_cuda(*k12m_args(xc4), **kwf),
                  lambda n: bkc._k12mc_cluster(n, *k12m_raw(xc4),
                                               max_rank=None, **kwf),
                  lambda: bkc.k12mc_block_cuda(*k12m_args(xc4), **kwf),
                  "k12mc", "a frozen 4-bond backward block")}
    lines = [f"{name}, {what} (cluster {default[name]}): " + time_cluster(
                 name, wrapper_fn, block_fn, sized_fn, placed[kern],
                 default[name])
             for name, (wrapper_fn, sized_fn, block_fn, kern, what)
             in timed.items()]
    print(f"{tag} per call at chi 25: " + "; ".join(lines) + f" ({card})",
          flush=True)


def k1a_cluster_phase(card: str, ptxas: str) -> None:
    """K1a and K1c-grad, one shard's gradient over a thread-block cluster,
    against their one-block kernels bit for bit over both directions x
    (chi, N) in (25, 100), (25, 50), (25, 32), (128, 100), K1a with KLD and
    MSE, at the default cluster and at every size the card places; a
    cluster of 32 blocks refused by the wrapper and, past it, by the card,
    with nothing launched; the occupancy of clusters; their ptxas entries;
    per-call ms of each against its one-block kernel in turns, and by
    cluster size."""
    from mpstime_tpu_torch.ops import bond_kernels as bk
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    tag = "[k1a-k1c-grad-cluster]"
    sizes = (1, 2, 4, 8, 16)
    names = {"k1a": "K1a", "k1c_grad": "K1c-grad"}
    cluster_fn = {"k1a": bk.k1a_cuda, "k1c_grad": bkc.k1c_grad_cuda}
    block_fn = {"k1a": bk.k1a_block_cuda,
                "k1c_grad": bkc.k1c_grad_block_cuda}
    default = {"k1a": bk.K1A_CLUSTER, "k1c_grad": bkc.K1C_GRAD_CLUSTER}
    occ = {(k, n): bk.cluster_occupancy(k, n, SHAPE["chi"])
           for k in names for n in sizes}
    placed = {k: [n for n in sizes if occ[(k, n)] >= 1] for k in names}
    for k in names:
        check(default[k] in placed[k], f"{names[k]}: the chosen cluster of "
              f"{default[k]} blocks cannot be placed: {occ}")
    print(f"{tag} cluster sizes K1a {bk.K1A_CLUSTER}, K1c-grad "
          f"{bkc.K1C_GRAD_CLUSTER} (blocks of 512 threads); clusters the "
          "card holds at once (cudaOccupancyMaxActiveClusters) at chi 25, "
          + "; ".join(f"{names[k]}: " + ", ".join(
              f"{n}: {occ[(k, n)]}" for n in sizes) for k in names)
          + f" ({card})", flush=True)
    if "no log" not in ptxas:
        mine = [e for e in ptxas.split("; ")
                if e.startswith("k1a_cluster_kernel")]
        check(len(mine) == 2, f"ptxas: no entry for the cluster K1a "
              f"({ptxas})")
        print(f"{tag} ptxas: " + "; ".join(mine), flush=True)

    def operands(key, seed, forward, shape=SHAPE):
        """One shard's (or tile's) operands, unit environment rows."""
        return dp_args(seed, forward, cplx=key == "k1c_grad",
                       shape=shape)[:9]

    def loss_kw(key, loss):
        return dict(loss=loss) if key == "k1a" else {}

    n_cases = {}
    for key, name in names.items():
        grid = [(chi, N, f, loss)
                for chi, N in ((25, 100), (25, 50), (25, 32), (128, 100))
                for f in (False, True)
                for loss in (("KLD", "MSE") if key == "k1a" else ("KLD",))]
        for i, (chi, N, forward, loss) in enumerate(grid):
            args = operands(key, 2300 + i, forward,
                            dict(SHAPE, chi=chi, N=N))
            kw = dict(forward=forward, **loss_kw(key, loss))
            ref = [block_fn[key](*args, **kw)]
            label = f"{name} chi={chi} N={N} {kw}"
            equal(f"{label} vs one block", [cluster_fn[key](*args, **kw)],
                  ref, ("G",))
            for n in placed[key]:
                equal(f"{label} cluster {n} vs one block",
                      [cluster_fn[key](*args, cluster=n, **kw)], ref, ("G",))
        n_cases[key] = len(grid)
    torch.cuda.synchronize()
    refused = {}
    for key, name in names.items():
        args = operands(key, 2390, False)
        # past the wrapper's check, the card refuses the launch itself
        if key == "k1a":
            def raw():
                return bk._k1a("mpst_k1a_cluster_launch", (32,), *args,
                               forward=False, loss="KLD")
        else:
            def raw():
                return bkc._k1c_grad("mpst_k1c_grad_cluster_launch", (32,),
                                     *args[:8], forward=False)
        refused[name] = refusal(
            name, lambda: cluster_fn[key](*args, forward=False, cluster=32),
            raw)
        # the refusal leaves no error behind for the next launch
        equal(f"{name} after a refusal",
              [cluster_fn[key](*args, forward=False)],
              [block_fn[key](*args, forward=False)], ("G",))
    print(f"{tag} cluster vs one block, torch.equal on G at the default "
          f"cluster and at every size placed ({placed['k1a']}, "
          f"{placed['k1c_grad']}): K1a {n_cases['k1a']} cases (both "
          "directions x (chi 25, N 100, 50, 32; chi 128, N 100) x KLD, MSE "
          f"with its log-scales), K1c-grad {n_cases['k1c_grad']} cases (both "
          "directions x the same shapes); a cluster of 32 blocks raises, "
          "nothing launched: " + "; ".join(f"{k}: {v}"
                                            for k, v in refused.items()),
          flush=True)

    lines = []
    for key, seed in (("k1a", 21), ("k1c_grad", 22)):
        args = operands(key, seed, False)
        lines.append(f"{names[key]} (cluster {default[key]}): "
                     + time_cluster(
                         names[key],
                         lambda: cluster_fn[key](*args, forward=False),
                         lambda: block_fn[key](*args, forward=False),
                         lambda n: cluster_fn[key](*args, forward=False,
                                                   cluster=n),
                         placed[key], default[key]))
    print(f"{tag} per call, one shard of a backward bond (chi 25, N 100, "
          "KLD): " + "; ".join(lines) + f" ({card})", flush=True)


def k1_cluster_phase(card: str, ptxas: str) -> None:
    """K1 and K1b, one real bond update over a thread-block cluster,
    against their one-block kernels bit for bit (both outputs) over both
    directions x (emit_y, q, orth) at the main-path shape, K1 also with MSE
    (its log-scales), GD, N 50 and 32, q 3 at chi 128 and a backward bond at
    chi 192, K1b also with GD and q 3 at chi 128, K1b's gradient from the
    cluster K1a on the same inputs, at the default cluster and at every
    size the card places; a cluster of 32 blocks refused by the wrapper
    and, past it, by the card, with nothing launched; the occupancy of
    clusters; their ptxas entries; per-call ms of each against its
    one-block kernel in turns, and by cluster size."""
    from mpstime_tpu_torch.ops import bond_kernels as bk
    tag = "[k1-k1b-cluster]"
    sizes = (1, 2, 4, 8, 16)
    names = {"k1": "K1", "k1b": "K1b"}
    cluster_fn = {"k1": bk.k1_cuda, "k1b": bk.k1b_cuda}
    block_fn = {"k1": bk.k1_block_cuda, "k1b": bk.k1b_block_cuda}
    default = {"k1": bk.K1_CLUSTER, "k1b": bk.K1B_CLUSTER}
    occ = {(k, n): bk.cluster_occupancy(k, n, SHAPE["chi"])
           for k in names for n in sizes}
    placed = {k: [n for n in sizes if occ[(k, n)] >= 1] for k in names}
    for k in names:
        check(default[k] in placed[k], f"{names[k]}: the chosen cluster of "
              f"{default[k]} blocks cannot be placed: {occ}")
    print(f"{tag} cluster sizes K1 {bk.K1_CLUSTER}, K1b {bk.K1B_CLUSTER} "
          "(blocks of 512 threads); clusters the card holds at once "
          "(cudaOccupancyMaxActiveClusters) at chi 25, "
          + "; ".join(f"{names[k]}: " + ", ".join(
              f"{n}: {occ[(k, n)]}" for n in sizes) for k in names)
          + f" ({card})", flush=True)
    if "no log" not in ptxas:
        mine = [e for e in ptxas.split("; ")
                if e.startswith(("k1_cluster_kernel<float>",
                                 "k1b_cluster_kernel<float>"))]
        check(len(mine) == 2, f"ptxas: no entry for the real cluster K1 "
              f"and K1b ({ptxas})")
        print(f"{tag} ptxas: " + "; ".join(mine), flush=True)

    def operands(key, seed, shape, forward):
        """K1's operands, or K1b's with the cluster K1a's gradient."""
        if key == "k1":
            return k1_args(bond_inputs(seed, 1, **shape), forward)
        a = dp_args(seed, forward, shape=shape)
        return (a[0], a[1], bk.k1a_cuda(*a[:9], forward=forward), a[9],
                0.05)

    # (shape, forward, emit_y, q, orth, extra keywords)
    grid = [(SHAPE, f, e, q, o, {}) for f in (False, True)
            for e, q, o in ((True, 1, "qr"), (True, 3, "qr"),
                            (False, 1, "qr"), (True, 1, "ns"),
                            (True, 3, "ns"))]
    grid += [(SHAPE, f, True, 1, "qr", dict(bbopt="GD"))
             for f in (False, True)]
    grid += [(dict(SHAPE, chi=128), f, True, 3, o, {}) for f in (False, True)
             for o in ("qr", "ns")]
    cases = {"k1b": grid, "k1": grid + [
        (SHAPE, f, True, 1, "qr", dict(loss="MSE")) for f in (False, True)]
        + [(dict(SHAPE, N=n), f, True, 1, "qr", {}) for n in (50, 32)
           for f in (False, True)]
        + [(dict(SHAPE, chi=192), False, True, 1, "qr", {})]}
    for key, name in names.items():
        for i, (shape, forward, emit_y, q, orth, extra) in enumerate(
                cases[key]):
            args = operands(key, 2400 + i, shape, forward)
            kw = dict(forward=forward, emit_y=emit_y, power_iters=q,
                      orth=orth, **extra)
            ref = block_fn[key](*args, **kw)
            label = f"{name} chi={shape['chi']} N={shape['N']} {kw}"
            equal(f"{label} vs one block", cluster_fn[key](*args, **kw), ref,
                  BT_Y)
            for n in placed[key]:
                equal(f"{label} cluster {n} vs one block",
                      cluster_fn[key](*args, cluster=n, **kw), ref, BT_Y)
    torch.cuda.synchronize()
    refused = {}
    for key, name in names.items():
        args = operands(key, 2490, SHAPE, False)
        raw = bk._k1 if key == "k1" else bk._k1b
        loss = dict(loss="KLD") if key == "k1" else {}
        # past the wrapper's check, the card refuses the launch itself
        refused[name] = refusal(
            name, lambda: cluster_fn[key](*args, forward=False, cluster=32),
            lambda: raw(f"mpst_{key}_cluster_launch", (32,), *args,
                        forward=False, emit_y=True, power_iters=1,
                        orth="qr", bbopt="TSGO", **loss))
        # the refusal leaves no error behind for the next launch
        equal(f"{name} after a refusal",
              cluster_fn[key](*args, forward=False),
              block_fn[key](*args, forward=False), BT_Y)
    print(f"{tag} cluster vs one block, torch.equal on BT and Y at the "
          f"default cluster and at every size placed ({placed['k1']}, "
          f"{placed['k1b']}): K1 {len(cases['k1'])} cases (both directions "
          "x (emit_y, q, orth) in (1, 1, qr), (1, 3, qr), (0, 1, qr), (1, 1, "
          "ns), (1, 3, ns) at chi 25; GD, MSE with its log-scales, N 50 and "
          "32 at (1, 1, qr); q 3, qr and ns at chi 128; a backward bond at "
          f"chi 192, q 1, qr), K1b {len(cases['k1b'])} cases (the same "
          "without MSE, N and chi 192; its gradient from the cluster K1a); "
          "a cluster of 32 blocks raises, nothing launched: " + "; ".join(
              f"{k}: {v}" for k, v in refused.items()), flush=True)

    xq = bond_inputs(7, 1, **SHAPE)
    xd = dp_args(21, False)
    G = bk.k1a_cuda(*xd[:9], forward=False)
    timed = {"k1": (k1_args(xq, False), dict(forward=False)),
             "k1b": ((xd[0], xd[1], G, xd[9], 0.05),
                     dict(forward=False, orth="ns"))}
    lines = [f"{names[key]} ({kw.get('orth', 'qr')}, q 1, cluster "
             f"{default[key]}): " + time_cluster(
                 names[key], lambda: cluster_fn[key](*args, **kw),
                 lambda: block_fn[key](*args, **kw),
                 lambda n: cluster_fn[key](*args, cluster=n, **kw),
                 placed[key], default[key])
             for key, (args, kw) in timed.items()]
    print(f"{tag} per call, a backward refresh bond at chi 25 (K1 the qr "
          "refresh bond, K1b the dp bond): " + "; ".join(lines)
          + f" ({card})", flush=True)


def k2_cluster_phase(card: str, ptxas: str) -> None:
    """K2, K2c, K2-split and K2c-split, the split (K2, K2c: and the
    environment advance) over a thread-block cluster, against their
    one-block kernels bit for bit over both directions x max_rank None and
    4 x a cutoff that keeps all directions and one that cuts at the
    main-path shape, chi 64 and 128, K2 and K2c at N 50 and 32, a basis
    with zero-energy columns and the tie-break bond, at the default cluster
    and at every size the card places; a cluster of 32 blocks refused by
    the wrapper and, past it, by the card, with nothing launched; the
    occupancy of clusters; their ptxas entries; device ms a call of each
    against its one-block kernel in turns, and by cluster size; a backward
    K2's and K2c's device ms by part (prefixes of the body); and the host's
    cost of a cluster launch against a one-block one."""
    from mpstime_tpu_torch.ops import bond_kernels as bk
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    from mpstime_tpu_torch.ops.decomp import _qr_orth
    tag = "[k2-k2split-cluster]"
    sizes = (1, 2, 4, 8, 16)
    names = {"k2": "K2", "k2c": "K2c", "k2_split": "K2-split",
             "k2c_split": "K2c-split"}
    mods = {k: bkc if k.startswith("k2c") else bk for k in names}
    cluster_fn = {k: getattr(m, f"{k}_cuda") for k, m in mods.items()}
    block_fn = {k: getattr(m, f"{k}_block_cuda") for k, m in mods.items()}
    default = {k: getattr(m, f"{k.upper()}_CLUSTER") for k, m in mods.items()}
    occ = {(k, n): bk.cluster_occupancy(k, n, SHAPE["chi"])
           for k in names for n in sizes}
    placed = {k: [n for n in sizes if occ[(k, n)] >= 1] for k in names}
    for k in names:
        check(default[k] in placed[k], f"{names[k]}: the chosen cluster of "
              f"{default[k]} blocks cannot be placed: {occ}")
    print(f"{tag} cluster sizes " + ", ".join(
        f"{names[k]} {default[k]}" for k in names) + " (blocks of 512 "
          "threads); clusters the card holds at once "
          "(cudaOccupancyMaxActiveClusters) at chi 25, " + "; ".join(
              f"{names[k]}: " + ", ".join(f"{n}: {occ[(k, n)]}"
                                          for n in sizes) for k in names)
          + f" ({card})", flush=True)
    if "no log" not in ptxas:
        mine = [e for e in ptxas.split("; ")
                if e.startswith(("k2_cluster_kernel",
                                 "k2_split_cluster_kernel"))]
        check(len(mine) == 4, f"ptxas: no entry for the cluster K2 and "
              f"K2-split ({ptxas})")
        print(f"{tag} ptxas: " + "; ".join(mine), flush=True)

    def operands(key, seed, shape, forward, zero_cols=0):
        """K2's (K2c's) operands: the plain K1's (K1c's, q 3) bond tensor,
        the QR (realified QR) of its Y with its last ``zero_cols`` columns
        zeroed, the advancing side's environment, log-scales and features;
        K2-split's (K2c-split's) the bond tensor and the basis."""
        if key.startswith("k2c"):
            x = bond_inputs_c(seed, 1, **shape)
            a1 = k1c_args(x, forward)
            BT, Y = bkc.k1c_plain(*a1, forward=forward, power_iters=3)
            Q = _qr_orth(Y).contiguous()
        else:
            x = bond_inputs(seed, 1, **shape)
            a1 = k1_args(x, forward)
            BT, Y = bk.k1_plain(*a1, forward=forward)
            Q = torch.linalg.qr(Y).Q.contiguous()
        if zero_cols:
            Q[:, -zero_cols:] = 0
        if key.endswith("_split"):
            return (BT, Q)
        env, phi = ((a1[2], x["phil"][0]) if forward
                    else (a1[3], x["phir"][0]))
        return (BT, Q, env, x["ls0"], phi)

    def tie_operands(key):
        """The tie-break bond (tie_break_inputs) as K2's or K2-split's
        operands, complex64 for K2c and K2c-split: its bond tensor (eta 0)
        and the basis V0, and its cutoff."""
        A, center, le, re, ls, phil, phir, y1h, w, V0, _, cutoff = \
            tie_break_inputs()
        if key.startswith("k2c"):
            A, center, le, re, phil, phir, V0 = (
                t.to(torch.complex64)
                for t in (A, center, le, re, phil, phir, V0))
            BT, _ = bkc.k1c_plain(A, center, le, re, phil, phir, y1h, w, V0,
                                  0.0, forward=False, emit_y=False)
        else:
            BT, _ = bk.k1_plain(A, center, le, re, phil, phir, y1h, w, ls,
                                V0, 0.0, forward=False, emit_y=False)
        return ((BT, V0) if key.endswith("_split")
                else (BT, V0, re, ls, phir)), cutoff

    labels = {k: ("center", "core", "Qm") if k.endswith("_split")
              else ("center", "core", "env", "env_ls") for k in names}
    n_cases, cut = {}, {}
    for key, name in names.items():
        split = key.endswith("_split")
        # (shape, forward, max_rank, cutoff, zeroed columns of Q)
        grid = [(SHAPE, f, mr, c, 0) for f in (False, True)
                for mr in (None, 4) for c in (1e-10, 0.05)]
        grid += [(dict(SHAPE, chi=chi), f, None, 1e-10, 0)
                 for chi in (64, 128) for f in (False, True)]
        if not split:
            grid += [(dict(SHAPE, N=n), f, None, 1e-10, 0) for n in (50, 32)
                     for f in (False, True)]
        grid += [(SHAPE, f, None, 1e-10, 5) for f in (False, True)]
        cases = []
        for i, (shape, forward, mr, cutoff, zc) in enumerate(grid):
            cases.append((operands(key, 2500 + i, shape, forward, zc)
                          + (cutoff,), dict(forward=forward, max_rank=mr),
                          f"chi={shape['chi']} N={shape['N']} "
                          f"max_rank={mr} cutoff={cutoff} zeroed={zc}"))
        tie, tie_cutoff = tie_operands(key)
        cases.append((tie + (tie_cutoff,), dict(forward=False), "tie-break"))
        for args, kw, label in cases:
            ref = block_fn[key](*args, **kw)
            kept_dirs = kept(ref[1], kw["forward"])
            if label == "tie-break":
                check(kept_dirs.tolist() == [True] * 3 + [False] * 3,
                      f"{name} tie-break kept {kept_dirs.tolist()}")
            elif "cutoff=0.05" in label or "zeroed=5" in label:
                # the cutoff of 5 % cuts: the least energy is at most the
                # mean, 4 % of the total at chi 25; zeroed columns carry none
                check(not bool(kept_dirs.all()), f"{name} {label}: nothing "
                      "cut")
                cut[key] = cut.get(key, 0) + 1
            equal(f"{name} {label} {kw} vs one block",
                  cluster_fn[key](*args, **kw), ref,
                  labels[key])
            for n in placed[key]:
                equal(f"{name} {label} {kw} cluster {n} vs one block",
                      cluster_fn[key](*args, cluster=n, **kw), ref,
                      labels[key])
        n_cases[key] = len(cases)
    torch.cuda.synchronize()
    raw = {"k2": bk._k2, "k2_split": bk._k2_split, "k2c": bkc._k2c,
           "k2c_split": bkc._k2c_split}
    refused = {}
    for key, name in names.items():
        args = operands(key, 2590, SHAPE, False) + (1e-10,)
        # past the wrapper's check, the card refuses the launch itself
        refused[name] = refusal(
            name, lambda: cluster_fn[key](*args, forward=False, cluster=32),
            lambda: raw[key](f"mpst_{key}_cluster_launch", (32,), *args,
                             forward=False, max_rank=None))
        # the refusal leaves no error behind for the next launch
        equal(f"{name} after a refusal", cluster_fn[key](*args, forward=False),
              block_fn[key](*args, forward=False),
              labels[key])
    print(f"{tag} cluster vs one block, torch.equal on center, core, env and "
          "env_ls (K2, K2c) and center, core and Qm (the splits) at the "
          "default cluster and at every size placed ("
          + "; ".join(f"{names[k]} {placed[k]}" for k in names) + "): "
          + ", ".join(f"{names[k]} {n_cases[k]}" for k in names)
          + " cases (both directions x max_rank None, 4 x cutoff 1e-10, "
          "0.05 at chi 25; chi 64 and 128; K2 and K2c at N 50 and 32; a basis "
          "with 5 zero-energy columns; the tie-break bond, which keeps "
          "directions 0..2), of which cut: " + ", ".join(
              f"{names[k]} {cut[k]}" for k in names)
          + "; a cluster of 32 blocks raises, nothing launched: " + "; ".join(
              f"{k}: {v}" for k, v in refused.items()), flush=True)

    # the timed calls: a qr refresh bond's K2 (K2c, q 3) and a dp bond's
    # K2-split (K2c-split, ns, q 1 and 3), backward, at the main-path shape
    x1 = bond_inputs(7, 1, **SHAPE)
    BT1, Y1 = bk.k1_cuda(*k1_args(x1, False), forward=False)
    xc1 = bond_inputs_c(17, 1, **SHAPE)
    BTc, Yc = bkc.k1c_cuda(*k1c_args(xc1, False), forward=False,
                           power_iters=3)
    xd, xdc = dp_args(21, False), dp_args(22, False, cplx=True)
    BTd, Yd = bk.k1b_cuda(xd[0], xd[1], bk.k1a_cuda(*xd[:9], forward=False),
                          xd[9], 0.05, forward=False, orth="ns")
    BTdc, Ydc = bkc.k1c_update_cuda(
        xdc[0], xdc[1], bkc.k1c_grad_cuda(*xdc[:9], forward=False), xdc[9],
        0.05, forward=False, orth="ns", power_iters=3)
    timed = {
        "k2": (BT1, torch.linalg.qr(Y1).Q.contiguous(), x1["envx"][0],
               x1["ls0"], x1["phir"][0], 1e-10),
        "k2c": (BTc, _qr_orth(Yc).contiguous(), xc1["envx"][0], xc1["ls0"],
                xc1["phir"][0], 1e-10),
        "k2_split": (BTd, Yd, 1e-10), "k2c_split": (BTdc, Ydc, 1e-10)}
    # device ms a call: the host's wrapper call (~50 us) outlasts these
    # kernels, so back-to-back event timing would time the host
    lines = [f"{names[key]} (cluster {default[key]}): " + time_cluster(
                 names[key], lambda: cluster_fn[key](*args, forward=False),
                 lambda: block_fn[key](*args, forward=False),
                 lambda n: cluster_fn[key](*args, cluster=n, forward=False),
                 placed[key], default[key], timer=time_queued_ms)
             for key, args in timed.items()]
    print(f"{tag} device ms a call (20 calls queued behind a spin of the "
          "card), backward at chi 25 (K2 and K2c a qr refresh bond's, q 1 "
          "and 3; the splits a dp bond's, ns): " + "; ".join(lines)
          + f" ({card})", flush=True)

    # by part: prefixes of the body (1 projection, after the real kron
    # factors; 2 + energies and mask; 3 + emission; 4 + advance), device
    # ms a call in 5 interleaved rounds
    parts = ("projection", "energies + mask", "emit", "advance")
    by_part = []
    for key, prefix in (("k2", bk._k2), ("k2c", bkc._k2c)):
        entry = f"mpst_{key}_cluster_parts_launch"
        args = timed[key]
        calls = [lambda u=u: prefix(entry, (u, default[key]), *args,
                                    forward=False, max_rank=None)
                 for u in (1, 2, 3)]
        calls.append(lambda: cluster_fn[key](*args, forward=False))
        rounds = [[] for _ in calls]
        for _ in range(5):
            for r, call in zip(rounds, calls):
                r.append(time_queued_ms(call))
        med = [statistics.median(r) for r in rounds]
        by_part.append(f"{names[key]} prefixes " + ", ".join(
            f"{m:.4f} ({min(r):.4f}-{max(r):.4f})"
            for m, r in zip(med, rounds)) + " ms, so by part " + ", ".join(
            f"{p} {m - m0:.4f}" for p, m, m0 in zip(parts, med,
                                                    [0.0] + med[:-1]))
            + " ms")
    print(f"{tag} a backward K2 and K2c (cluster {bk.K2_CLUSTER}, "
          f"{bkc.K2C_CLUSTER}) by part, device ms a call, medians (min-max) "
          "of 5 interleaved rounds of the body's prefixes: "
          + "; ".join(by_part) + f" ({card})", flush=True)

    # the host's cost of a launch: 1000 calls of each form, unsynced, in 5
    # batches of 200 queued behind a spin of the card (so the host never
    # waits for it), through the wrapper and through the bare C entry (its
    # C arguments captured once, with a workspace held here)
    from mpstime_tpu_torch.kernels.build import load_library
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def host_us(fn, batches=5, per=200):
        total = 0.0
        for _ in range(batches):
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(per):
                fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * total / (batches * per)

    forms = {"K2 wrapper": (lambda: bk.k2_cuda(*timed["k2"], forward=False),
                            lambda: bk.k2_block_cuda(*timed["k2"],
                                                     forward=False))}
    held = []
    for key, ws_floats, dtype in (
            ("k2", lib.mpst_k12_workspace_floats, torch.float32),
            ("k2c", lib.mpst_c_workspace_floats, torch.complex64)):
        c_args = []
        held.append(bk._launch_k2(*timed[key], forward=False, max_rank=None,
                                  launch=lambda *a: c_args.extend(a),
                                  workspace_floats=ws_floats, dtype=dtype))
        held.append(torch.empty(ws_floats(*c_args[10:14]), device="cuda"))
        c_args[9] = held[-1].data_ptr()          # a workspace that stays
        cluster_entry = getattr(lib, f"mpst_{key}_cluster_launch")
        block_entry = getattr(lib, f"mpst_{key}_launch")
        forms[f"{names[key]} C entry"] = (
            lambda e=cluster_entry, a=tuple(c_args), n=default[key]:
                e(*a, n, stream),
            lambda e=block_entry, a=tuple(c_args): e(*a, stream))
    us = {}
    for _ in range(3):
        for label, (cluster_call, block_call) in forms.items():
            us.setdefault((label, "cluster"), []).append(
                host_us(cluster_call))
            us.setdefault((label, "one block"), []).append(
                host_us(block_call))
    check(all(rc == 0 for rc in (forms["K2 C entry"][0](),
                                 forms["K2c C entry"][0]())),
          "the bare C entries failed")
    torch.cuda.synchronize()
    print(f"{tag} host us a launch, 1000 unsynced calls in 5 batches of 200 "
          "queued behind a spin of the card, median (min-max) of 3 rounds, "
          "backward at chi 25: " + "; ".join(
              f"{label} {form} {statistics.median(v):.2f} "
              f"({min(v):.2f}-{max(v):.2f})"
              for (label, form), v in us.items()) + f" ({card})", flush=True)


def k2env_k1tail_phase(card: str, ptxas: str) -> None:
    """K2-env and K2c-env over independent row tiles, and K1-tail and
    K1c-tail over a cooperative grid, against their one-block kernels bit
    for bit: the row kernels over both directions x N 1, 7, 32, 50, 100 x
    rows a block 1-32 and the default; the grid tails over both directions
    x chi 25 and 192 x orth ns and qr x q 1 and 3 at grids of 1, 2, 16, 66
    blocks, the most the card holds and the default; a grid past that
    refused by the card, with nothing launched; their ptxas entries; device
    ms a call of each against its one-block kernel in turns, K2-env and
    K2c-env by rows a block at N 100, 50 and 32 (queued behind a spin of
    the card), K1-tail at chi 192, 256 and 320 and K1c-tail at chi 128 and
    192 by grid size (events, over several calls); fails unless each new
    kernel beats its one-block kernel and each default is the fastest
    within the spread."""
    from mpstime_tpu_torch.ops import bond_kernels as bk
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    tag = "[k2env-k1tail-redesign]"
    most = {k: bk.grid_occupancy(k) for k in bk.GRID_KERNELS}
    default = {"k2_env": bk.K2_ENV_ROWS, "k2c_env": bkc.K2C_ENV_ROWS,
               "k1_tail": bk.K1_TAIL_BLOCKS, "k1c_tail": bkc.K1C_TAIL_BLOCKS}
    for k in bk.GRID_KERNELS:
        check(default[k] <= most[k], f"{k}: the default grid of "
              f"{default[k]} blocks exceeds what the card holds ({most[k]})")
    names = {"k2_env": "K2-env", "k2c_env": "K2c-env", "k1_tail": "K1-tail",
             "k1c_tail": "K1c-tail"}
    mods = {k: bkc if k in ("k2c_env", "k1c_tail") else bk for k in names}
    new_fn = {k: getattr(m, f"{k}_cuda") for k, m in mods.items()}
    block_fn = {k: getattr(m, f"{k}_block_cuda") for k, m in mods.items()}
    print(f"{tag} rows a block K2-env {default['k2_env']}, K2c-env "
          f"{default['k2c_env']}; grid K1-tail {default['k1_tail']}, K1c-tail "
          f"{default['k1c_tail']} blocks of 512 threads; the most blocks the "
          "card holds at once (occupancy x SMs): " + ", ".join(
              f"{names[k]} {v}" for k, v in most.items()) + f" ({card})",
          flush=True)
    if "no log" not in ptxas:
        mine = [e for e in ptxas.split("; ")
                if e.startswith(("k2_env_rows_kernel", "k1_tail_grid_kernel"))]
        check(len(mine) == 6, f"ptxas: no entry for the row-tile K2-env "
              f"(staged and not) and the grid K1-tail ({ptxas})")
        print(f"{tag} ptxas: " + "; ".join(mine), flush=True)

    def env_operands(key, seed, N, forward):
        """K2-env's (K2c-env's) operands at chi 25: the masked isometry of
        the plain K2-split (K2c-split) of a K1 (K1c, q 3) bond and its QR
        basis, and the advancing side's environment, log-scales and
        features of N rows."""
        from mpstime_tpu_torch.ops.decomp import _qr_orth
        if key == "k2c_env":
            x = bond_inputs_c(seed, 1, **dict(SHAPE, N=N))
            BT, Y = bkc.k1c_plain(*k1c_args(x, forward), forward=forward,
                                  power_iters=3)
            Qm = bkc.k2c_split_plain(BT, _qr_orth(Y).contiguous(), 1e-10,
                                     forward=forward)[2]
        else:
            x = bond_inputs(seed, 1, **dict(SHAPE, N=N))
            BT, Y = bk.k1_plain(*k1_args(x, forward), forward=forward)
            Qm = bk.k2_split_plain(BT, torch.linalg.qr(Y).Q.contiguous(),
                                   1e-10, forward=forward)[2]
        env, phi = ((x["env0"], x["phil"][0]) if forward
                    else (x["env0"], x["phir"][0]))
        return (Qm.contiguous(), env, x["ls0"], phi)

    def tail_operands(key, seed, chi, forward):
        """A stepped bond tensor (the plain K1's, K1c's, without its power
        step) and the sketch V0 at bond width chi."""
        if key == "k1c_tail":
            x = bond_inputs_c(seed, 1, **dict(SHAPE, chi=chi))
            BT, _ = bkc.k1c_plain(*k1c_args(x, forward), forward=forward,
                                  emit_y=False)
        else:
            x = bond_inputs(seed, 1, **dict(SHAPE, chi=chi))
            BT, _ = bk.k1_plain(*k1_args(x, forward), forward=forward,
                                emit_y=False)
        return BT, x["V0"][0]

    rows_set = (1, 2, 4, 8, 16, 32)
    n_cases = dict.fromkeys(names, 0)
    for key in ("k2_env", "k2c_env"):
        for i, (N, forward) in enumerate((n, f) for n in (1, 7, 32, 50, 100)
                                         for f in (False, True)):
            args = env_operands(key, 2700 + i, N, forward)
            ref = block_fn[key](*args, forward=forward)
            for rows in (None,) + rows_set:
                equal(f"{names[key]} N={N} forward={forward} rows={rows}",
                      new_fn[key](*args, forward=forward, rows=rows), ref,
                      ("env", "env_ls"))
                n_cases[key] += 1
    for key in ("k1_tail", "k1c_tail"):
        for i, (chi, orth, q, forward) in enumerate(
                (c, o, q, f) for c in (SHAPE["chi"], 192) for o in ("ns", "qr")
                for q in (1, 3) for f in (False, True)):
            BT, V0 = tail_operands(key, 2800 + i, chi, forward)
            kw = dict(forward=forward, power_iters=q, orth=orth)
            ref = block_fn[key](BT, V0, **kw)
            for n in (None, 1, 2, 16, 66, most[key]):
                equal(f"{names[key]} chi={chi} {kw} blocks={n}",
                      [new_fn[key](BT, V0, blocks=n, **kw)], [ref], ("Y",))
                n_cases[key] += 1
    torch.cuda.synchronize()
    refused = {}
    for key in ("k1_tail", "k1c_tail"):
        BT, V0 = tail_operands(key, 2890, SHAPE["chi"], False)
        before = dict(bk.LAUNCHES)
        try:
            new_fn[key](BT, V0, forward=False, blocks=most[key] + 1)
            torch.cuda.synchronize()
            said = "launched"
        except RuntimeError as exc:
            said = f"RuntimeError ({str(exc).split(': ', 1)[-1]})"
        check("launched" not in said, f"{names[key]}: a grid of "
              f"{most[key] + 1} blocks launched")
        check(dict(bk.LAUNCHES) == before, f"{names[key]}: a refused grid "
              "launched a kernel")
        equal(f"{names[key]} after a refusal",
              [new_fn[key](BT, V0, forward=False)],
              [block_fn[key](BT, V0, forward=False)], ("Y",))
        refused[names[key]] = said
    print(f"{tag} new vs one block, torch.equal on env and env_ls (K2-env, "
          "K2c-env: both directions x N 1, 7, 32, 50, 100 x rows a block "
          f"default, {', '.join(map(str, rows_set))}) and on Y (K1-tail, "
          "K1c-tail: both directions x chi 25, 192 x ns, qr x q 1, 3 at "
          "grids of the default, 1, 2, 16, 66 and the most blocks): "
          + ", ".join(f"{names[k]} {v}" for k, v in n_cases.items())
          + " cases; a grid one past the most: " + "; ".join(
              f"{k} {v}" for k, v in refused.items())
          + ", nothing launched", flush=True)

    # K2-env and K2c-env: device ms a call queued behind a spin, against
    # the one block in turns at N 100 (the dp shape), 50 and 32, and by rows
    # a block over 5 interleaved rounds, with the default rows unstaged
    # (Qm and the factors read from global memory) beside them; the default
    # must be the fastest summed over the three Ns within the summed spread
    raw = {"k2_env": lambda *a, **k: bk._k2_env(
               "mpst_k2_env_rows_launch", (default["k2_env"], 0), *a, **k),
           "k2c_env": lambda *a, **k: bkc._k2c_env(
               "mpst_k2c_env_rows_launch", (default["k2c_env"], 0), *a,
               **k)}
    lines = []
    for key in ("k2_env", "k2c_env"):
        by_n, turns, unstaged = {}, {}, {}
        for N in (100, 50, 32):
            args = env_operands(key, 2950, N, False)
            t_new, t_one = time_turns(
                lambda: new_fn[key](*args, forward=False),
                lambda: block_fn[key](*args, forward=False), rounds=3,
                iters=20, timer=time_queued_ms)
            turns[N] = (statistics.median(t_new), statistics.median(t_one))
            check(turns[N][0] < turns[N][1], f"{names[key]} at N {N}: "
                  f"{turns[N][0]:.4f} ms is not below one block's "
                  f"{turns[N][1]:.4f}")
            rounds = {r: [] for r in rows_set}
            unstaged[N] = []
            equal(f"{names[key]} unstaged", raw[key](*args, forward=False),
                  new_fn[key](*args, forward=False), ("env", "env_ls"))
            for _ in range(5):
                for r in rows_set:
                    rounds[r].append(time_queued_ms(
                        lambda r=r: new_fn[key](*args, forward=False,
                                                rows=r)))
                unstaged[N].append(time_queued_ms(
                    lambda: raw[key](*args, forward=False)))
            by_n[N] = rounds
        total = {r: sum(statistics.median(by_n[N][r]) for N in by_n)
                 for r in rows_set}
        spread = {r: sum(max(by_n[N][r]) - min(by_n[N][r]) for N in by_n)
                  for r in rows_set}
        fast, mine = min(total, key=total.get), default[key]
        check(total[mine] - total[fast] <= max(spread[mine], spread[fast]),
              f"{names[key]}: the default of {mine} rows a block "
              f"({total[mine]:.4f} ms summed) is slower than {fast} "
              f"({total[fast]:.4f}) by more than the spread")
        lines.append(f"{names[key]} (rows {mine}) " + "; ".join(
            f"N {N}: {turns[N][0]:.4f} vs one block {turns[N][1]:.4f} "
            f"({turns[N][1] / turns[N][0]:.2f}x), by rows " + ", ".join(
                f"{r}: {statistics.median(t):.4f} ({min(t):.4f}-"
                f"{max(t):.4f})" for r, t in by_n[N].items())
            + f"; {mine} unstaged {statistics.median(unstaged[N]):.4f} "
            f"({min(unstaged[N]):.4f}-{max(unstaged[N]):.4f})"
            for N in by_n) + f" (fastest summed {fast})")
    print(f"{tag} device ms a call (20 calls queued behind a spin of the "
          "card; medians in turns with the one-block kernel, then by rows a "
          "block, staged where they fit, and the default unstaged, median "
          "(min-max) of 5 interleaved rounds), backward at chi 25: "
          + "; ".join(lines) + f" ({card})", flush=True)

    # K1-tail and K1c-tail: one power step (ns, q 1) of a stored backward
    # bond tensor, at the main-path shape device ms a call queued behind a
    # spin against the one block in turns; at large chi ms a call by events
    # over 3 calls, against the one block in turns, and by grid size over 3
    # interleaved rounds
    lines = []
    for key in ("k1_tail", "k1c_tail"):
        BT, V0 = tail_operands(key, 2955, SHAPE["chi"], False)
        kw = dict(forward=False, power_iters=1, orth="ns")
        t_new, t_one = time_turns(
            lambda: new_fn[key](BT, V0, **kw),
            lambda: block_fn[key](BT, V0, **kw), rounds=3, iters=20,
            timer=time_queued_ms)
        new_ms, one_ms = statistics.median(t_new), statistics.median(t_one)
        lines.append(f"{names[key]} chi {SHAPE['chi']} (device, queued): "
                     f"{new_ms:.4f} ({min(t_new):.4f}-{max(t_new):.4f}) vs "
                     f"one block {one_ms:.4f} ({min(t_one):.4f}-"
                     f"{max(t_one):.4f}) ({one_ms / new_ms:.2f}x)")
    for key, chis in (("k1_tail", (192, 256, 320)),
                      ("k1c_tail", (128, 192))):
        for chi in chis:
            BT, V0 = tail_operands(key, 2960 + chi, chi, False)
            kw = dict(forward=False, power_iters=1, orth="ns")
            t_new, t_one = time_turns(
                lambda: new_fn[key](BT, V0, **kw),
                lambda: block_fn[key](BT, V0, **kw), rounds=1, iters=1)
            new_ms, one_ms = statistics.median(t_new), statistics.median(t_one)
            check(new_ms < one_ms, f"{names[key]} at chi {chi}: {new_ms:.3f} "
                  f"ms is not below one block's {one_ms:.3f}")
            sizes = sorted({16, 32, 66, most[key]})
            rounds = {n: [] for n in sizes}
            for _ in range(3):
                for n in sizes:
                    rounds[n].append(time_ms(
                        lambda n=n: new_fn[key](BT, V0, blocks=n, **kw), 3,
                        warmup=1))
            med = {n: statistics.median(t) for n, t in rounds.items()}
            fast, mine = min(med, key=med.get), default[key]
            spread = max(max(rounds[n]) - min(rounds[n]) for n in (fast, mine))
            check(med[mine] - med[fast] <= spread, f"{names[key]} at chi "
                  f"{chi}: the default grid of {mine} ({med[mine]:.4f} ms) is "
                  f"slower than {fast} ({med[fast]:.4f}) by more than the "
                  f"spread {spread:.4f}")
            lines.append(
                f"{names[key]} chi {chi}: {new_ms:.4f} vs one block "
                f"{one_ms:.4f} ({one_ms / new_ms:.1f}x); by grid " + ", ".join(
                    f"{n}: {med[n]:.4f} ({min(t):.4f}-{max(t):.4f})"
                    for n, t in rounds.items()) + f" (fastest {fast})")
    print(f"{tag} ms a call of one power step (ns, q 1) of a stored backward "
          "bond tensor (C 2, d 5): events over 3 calls in turns with the "
          "one-block kernel, then by grid size, median (min-max) of 3 "
          "interleaved rounds: " + "; ".join(lines) + f" ({card})",
          flush=True)




def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


#: The sweep's record_function ranges (training/sweep.py).  torch.profiler
#: also lists them among the device events, as spans over the kernels they
#: hold, so the device-time sums below leave them out.
SCOPES = ("mps/backward_bond", "mps/forward_bond")


def device_ms(prof) -> dict:
    """Device ms by kernel of a torch.profiler run (each event's own time),
    the sweep's ranges left out."""
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in SCOPES}


def _synced_s(fn):
    """Host seconds of one call of ``fn`` that ends in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _median_s(fn, calls: int = 3):
    """Median host seconds of ``calls`` synced calls after one warm-up."""
    fn()
    return statistics.median(_synced_s(fn)[0] for _ in range(calls))


def _to_f64(mt, trained, device):
    """The trained weights cast to double on ``device``, with the training
    set (the default closed-form basis has no encoding arguments)."""
    d = trained.train_data
    cast = {torch.float32: torch.float64, torch.complex64: torch.complex128}
    dt = cast[trained.mps.dtype]
    return mt.TrainedMPS.from_numpy(
        trained.mps.cores.to(dt).cpu().numpy(),
        trained.mps.center.to(dt).cpu().numpy(), trained.mps.center_pos,
        trained.opts.replace(dtype=str(dt).split(".")[-1]), trained.norms,
        trained.labels, enc_args=d.enc_args, device=device,
        X_train=d.X_orig, y_train=d.labels[d.y_idx])


def _known_exact(mt, imp, X, sites, ts_scaled):
    """Known sites of a scaled imputation equal the scaled inputs (in the
    scan's precision) bit for bit."""
    filled = np.array(X, dtype=np.float64)
    filled[..., sites] = float(np.mean(imp.X_train))
    scaled, _ = mt.transform_test_data(filled, imp.norms, imp.opts)
    want = scaled.astype(np.float32 if imp.rdtype == torch.float32
                         else np.float64).astype(np.float64)
    known = np.setdiff1d(np.arange(imp.T), sites)
    return bool(np.array_equal(ts_scaled[..., known], want[..., known]))


def impute_batch_phase(mt, bk, imp, label: str, card: str, Xte, yte):
    """impute_batch over min(35, class count) instances of the first test
    class, one 20 % MAR window, by median: the median of 3 timed calls,
    the MAE on the missing sites, finiteness and exact known sites; and
    one call under torch.profiler (the card's busy share of it)."""
    from mpstime_tpu_torch.imputation import impute_batch
    cls = np.unique(yte)[0]
    B = min(35, int(np.sum(yte == cls)))
    sites = mt.mar(Xte[0], 0.2, rng=np.random.default_rng(0))[1]
    bk.reset_counts()
    run = lambda: impute_batch(imp, cls, np.arange(B), sites, "median")  # noqa: E731
    secs = _median_s(run)
    ts, targets = run()
    check(sum(bk.LAUNCHES.values()) + sum(bk.PLAIN_CALLS.values()) == 0,
          f"{label}: imputation launched a bond kernel")
    check(ts.shape == (B, len(Xte[0])) and np.isfinite(ts).all(),
          f"{label}: impute_batch gave {ts.shape}, finite "
          f"{np.isfinite(ts).all()}")
    scaled, _ = impute_batch(imp, cls, np.arange(B), sites, "median",
                             invert_transform=False)
    X_cls = imp.X_test[np.where(imp.y_test == cls)[0][:B]]
    check(_known_exact(mt, imp, X_cls, sites, scaled),
          f"{label}: known sites did not come back exactly")
    mae = float(np.mean(np.abs(ts[:, sites] - targets[:, sites])))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = _synced_s(run)
    busy = sum(device_ms(prof).values())
    print(f"[{label}] impute_batch (median, dx {IMPUTE_DX}, G "
          f"{len(imp.grid_x)}) of class {cls}: B {B}, {len(sites)} missing "
          f"sites of {imp.T}: {secs:.4f} s (median of 3 synced calls after 1 "
          f"warm-up); MAE on the missing sites {mae:.4f}; one profiled call: "
          f"device busy {busy:.1f} ms of {1e3 * wall:.1f} ms "
          f"({100 * busy / (1e3 * wall):.1f} %) ({card})", flush=True)
    return secs, mae


def impute_phases(card: str) -> None:
    """Phases 24-27: fit on the card, then impute and analyse there."""
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.imputation import impute_windows
    from mpstime_tpu_torch.ops import bond_kernels as bk
    data = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    Xtr, ytr, Xte, yte = (data["X_train"], data["y_train"], data["X_test"],
                          data["y_test"])

    # ---- 24. impute path: the JAX bench's imputation cell ----------------
    t_phase = time.perf_counter()
    bk.reset_counts()
    trained, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
        nsweeps=3, chi_max=25, d=5, dtype="float32", verbosity=-1,
        log_level=-1), device="cuda")
    torch.cuda.synchronize()
    launches, plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k12m": 3 * 24}
    check(launches == want, f"impute-path fit: launches {launches} != {want}")
    check(sum(plain.values()) == 0,
          f"impute-path fit: plain-version calls on the card {plain}")
    init_s, imp = _synced_s(lambda: mt.init_imputation_problem(
        trained, Xte, yte, verbosity=-1, dx=IMPUTE_DX, test_encoding=True))
    check(imp.cores_full[0].is_cuda and imp.grid.dtype == torch.float32,
          "impute-path: the problem is not on the card in float32")
    batch_s, batch_mae = impute_batch_phase(mt, bk, imp, "impute-path", card,
                                            Xte, yte)

    cls = np.unique(yte)[0]
    inst = 3
    sites = mt.mar(Xte[5], 0.2, rng=42)[1]
    target = Xte[np.where(yte == cls)[0][inst]]
    known = np.setdiff1d(np.arange(len(target)), sites)
    runs = {"median": {}, "mean": {}, "mode": {},
            "mode max_jump 0.05": dict(max_jump=0.05),
            "ITS x3": dict(num_trajectories=3, rseed=5),
            "ITS rejection 2.5": dict(rejection_threshold=2.5, rseed=5),
            "kNN": {}}
    maes, method_s = {}, {}
    for name, kw in runs.items():
        method = name.split()[0].replace("kNN", "kNearestNeighbour")
        s, out = _synced_s(lambda: mt.mps_impute(
            imp, cls, inst, sites, method, NN_baseline=False, **kw))
        ts = np.stack(out[0])
        check(np.isfinite(ts).all(), f"mps_impute {name}: non-finite values")
        if method != "kNearestNeighbour":
            check(np.allclose(ts[:, known], target[known], rtol=1e-5,
                              atol=1e-6),
                  f"mps_impute {name}: known sites moved")
        maes[name], method_s[name] = out[3][0]["MAE"], s
    again = mt.mps_impute(imp, cls, inst, sites, "ITS", NN_baseline=False,
                          num_trajectories=3, rseed=5)[0]
    first = mt.mps_impute(imp, cls, inst, sites, "ITS", NN_baseline=False,
                          num_trajectories=3, rseed=5)[0]
    check(all(np.array_equal(a, b) for a, b in zip(again, first)),
          "ITS did not reproduce under the same rseed")
    cdfs, _, _, _ = mt.get_cdfs(imp, cls, inst, sites)
    check(np.isfinite(cdfs).all() and cdfs.shape == (len(sites),
                                                     len(imp.grid_x)),
          f"get_cdfs: shape {cdfs.shape}")
    check(bool(np.all(np.diff(cdfs, axis=1) >= -1e-6)),
          "get_cdfs: a cdf is not monotone")
    check(np.allclose(cdfs[:, 0], 0, atol=1e-6)
          and np.allclose(cdfs[:, -1], 1, atol=1e-5),
          f"get_cdfs: ends {cdfs[:, 0].max()}, {cdfs[:, -1].min()}")
    traj_s, traj = _synced_s(lambda: mt.sample_trajectories(
        trained, n=16, rseed=7))
    check(traj.shape == (16, len(target)) and np.isfinite(traj).all(),
          f"sample_trajectories: {traj.shape}")
    # the median beats the flat baseline (tests/test_imputation.py:68-80)
    rng = np.random.default_rng(0)
    mps_mae = flat_mae = 0.0
    for i in range(5):
        w = mt.mar(Xte[i], 0.3, rng=rng)[1]
        mps_mae += mt.mps_impute(imp, 1, i, w, "median",
                                 NN_baseline=False)[3][0]["MAE"]
        flat_mae += mt.mps_impute(imp, 1, i, w, "flatBaseline",
                                  NN_baseline=False)[3][0]["MAE"]
    check(mps_mae < flat_mae, f"median MAE {mps_mae / 5:.4f} does not beat "
          f"the flat baseline's {flat_mae / 5:.4f}")
    print(f"[impute-path] ECG200 MPSOptions(nsweeps=3, chi_max=25, d=5, "
          f"dtype='float32') on cuda: launches {_nonzero(launches)}; plain "
          f"calls {_nonzero(plain)}; init_imputation_problem (test_encoding, dx "
          f"{IMPUTE_DX}) {init_s:.3f} s; mps_impute of instance {inst} "
          f"({len(sites)} missing) MAE and s: " + "; ".join(
              f"{k} {maes[k]:.4f} {method_s[k]:.3f}" for k in runs)
          + f"; get_cdfs monotone 0 -> 1; sample_trajectories(n=16) "
          f"{traj_s:.3f} s; median MAE over 5 instances of 30 % windows "
          f"{mps_mae / 5:.4f} < flatBaseline {flat_mae / 5:.4f}; ITS "
          f"reproduces under rseed 5; phase {time.perf_counter() - t_phase:.1f}"
          f" s ({card})", flush=True)

    # ---- 25. impute vs cpu: float64 weights on the card and on the CPU --
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1)
    windows = [mt.mar(Xte[0], p, rng=rng)[1] for p in (0.1, 0.2, 0.3)]
    n_sites = 8 * sum(len(w) for w in windows)
    probs = {dev: mt.init_imputation_problem(
        _to_f64(mt, trained, dev), Xte, yte, verbosity=-1, dx=IMPUTE_DX)
        for dev in ("cuda", "cpu")}
    lines = []
    for method in ("median", "mean", "mode"):
        out = {}
        for dev, p in probs.items():
            out[dev], _ = impute_windows(p, cls, np.arange(8), windows,
                                         method, invert_transform=False)
        x32, _ = impute_windows(imp, cls, np.arange(8), windows, method,
                                invert_transform=False)
        diff = np.abs(out["cuda"] - out["cpu"])
        miss = np.concatenate([out["cuda"][iw][:, w].ravel()
                               for iw, w in enumerate(windows)])
        miss64 = np.concatenate([out["cpu"][iw][:, w].ravel()
                                 for iw, w in enumerate(windows)])
        miss32 = np.concatenate([x32[iw][:, w].ravel()
                                 for iw, w in enumerate(windows)])
        check(np.isfinite(out["cuda"]).all(), f"{method}: non-finite")
        check(diff.max() <= IMPUTE_DX + 1e-12, f"impute-vs-cpu {method}: "
              f"max |card - cpu| {diff.max():.3e} > dx {IMPUTE_DX}")
        lines.append(
            f"{method} max |diff| {diff.max():.3e}, {int(np.sum(np.abs(miss - miss64) > IMPUTE_DX / 2))}"
            f" of {n_sites} missing sites moved a grid step, float32 card vs "
            f"float64 MAE {float(np.mean(np.abs(miss32 - miss64))):.3e} "
            "(scaled units)")
    print(f"[impute-vs-cpu] impute_windows (3 windows x 8 instances of class "
          f"{cls}, dx {IMPUTE_DX}) of the float64 weights on cuda vs the CPU: "
          + "; ".join(lines) + f"; phase {time.perf_counter() - t_phase:.1f}"
          f" s ({card})", flush=True)

    # ---- 26. complex impute path: the fourier fit (K12c) ---------------
    t_phase = time.perf_counter()
    bk.reset_counts()
    ctrained, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
        encoding="fourier", nsweeps=3, verbosity=-1, log_level=-1),
        device="cuda")
    torch.cuda.synchronize()
    c_launches, c_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k12c": 3 * 190}
    check(c_launches == want,
          f"complex impute fit: launches {c_launches} != {want}")
    check(sum(c_plain.values()) == 0,
          f"complex impute fit: plain-version calls on the card {c_plain}")
    cimp = mt.init_imputation_problem(ctrained, Xte, yte, verbosity=-1,
                                      dx=IMPUTE_DX)
    check(cimp.grid_states[0].dtype == torch.complex64,
          "complex impute: the grid states are not complex64")
    cbatch_s, cbatch_mae = impute_batch_phase(mt, bk, cimp,
                                              "complex-impute-path", card,
                                              Xte, yte)
    print(f"[complex-impute-path] ECG200 MPSOptions(encoding='fourier', "
          f"nsweeps=3) (complex64) on cuda: launches {_nonzero(c_launches)}; "
          f"plain calls {_nonzero(c_plain)}; impute_batch {cbatch_s:.4f} s, MAE "
          f"{cbatch_mae:.4f}; phase {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)

    # ---- 27. analysis path -------------------------------------------------
    t_phase = time.perf_counter()
    series = Xte[:4]

    def analyse(tr):
        m0 = mt.models.mps.expand_label_index(tr.mps)[0]
        return {"bipartite": np.stack(mt.bipartite_spectrum(tr)),
                "single_site": np.stack(mt.single_site_spectrum(tr)),
                "rdm": mt.one_site_rdm(m0, 40),
                "see": mt.see_variation(tr, series)}

    gpu64 = analyse(_to_f64(mt, trained, "cuda"))
    cpu64 = analyse(_to_f64(mt, trained, "cpu"))
    f32 = analyse(trained)
    see_s, _ = _synced_s(lambda: mt.see_variation(trained, series))
    see64_s, _ = _synced_s(lambda: mt.see_variation(
        _to_f64(mt, trained, "cuda"), series))
    diffs = {k: float(np.abs(gpu64[k] - cpu64[k]).max()) for k in cpu64}
    diffs32 = {k: float(np.abs(f32[k] - cpu64[k]).max()) for k in cpu64}
    for k, v in diffs.items():
        check(np.isfinite(gpu64[k]).all() and np.isfinite(f32[k]).all(),
              f"analysis {k}: non-finite")
        check(v <= ENTROPY_ATOL, f"analysis {k}: float64 card vs cpu {v:.3e}"
              f" > {ENTROPY_ATOL}")
    print(f"[analysis-path] bipartite_spectrum, single_site_spectrum, "
          f"one_site_rdm and see_variation of {len(series)} test series "
          f"(T {trained.mps.T}): float64 card vs CPU max |diff| " + ", ".join(
              f"{k} {v:.2e}" for k, v in diffs.items())
          + "; float32 card vs float64 CPU " + ", ".join(
              f"{k} {v:.2e}" for k, v in diffs32.items())
          + f"; see_variation {see_s:.3f} s (float32), {see64_s:.3f} s "
          f"(float64); phase {time.perf_counter() - t_phase:.1f} s ({card})",
          flush=True)


# the 13 per-fold keys of the reference's evaluate results
# (tests/data/eval_results.jld2, read by tests/test_eval_oracle.py:79-89)
EVAL_KEYS = {"fold", "objective", "train_inds", "test_inds", "optimiser",
             "tuning_windows", "tuning_pms", "eval_windows", "eval_pms",
             "time", "opts", "cache", "loss"}
# the MPSTime.jl-trained ECG200 model's pins (tests/test_itensor_import.py:
# 28-29): its test accuracy and the median imputation's MAE, instance 0 of
# class 0, sites 30-49
REF_TEST_ACC = 0.84
REF_IMPUTE_MAE = 0.1883971410956766
REF_MAE_RTOL = 1e-8
# the padded site directions of a padded fit: the state's weight there.
# The cores' raw share, which tests/test_padded.py:136 holds under 1e-7 at
# its 3-sweep cut (tests/test_torch_cuda.py holds the port there on the
# card), is dominated at ECG200's 10 sweeps by the near-null kept columns of
# site 1's core, the QR's fill-in (5.7e-6 on the kernels, 1.0e-6 on their
# plain versions on the H100, PERF.md).  The state's weight there after 10
# sweeps is 5.0e-7 on the kernels and 2.8e-7 on the plain versions on the
# card (tests/torch_padded_probe.py); on the same inputs each bond's kernels
# add what the plain versions add (tests/test_torch_cuda.py), so the bound
# is a few times the plain reading
PAD_DEAD_WEIGHT = 1e-6
PAD_ACC_FLOOR = 0.75             # tests/test_padded.py:70


def _reference_model(mt, device):
    """The ECG200 model MPSTime.jl trained: from its .jld2 where h5py is
    installed, else from the .npz the port's save_mps wrote from it
    (tests/test_torch_serialize_import.py holds the two equal)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        path = ROOT / "tests" / "data" / "reference_trained_ecg200_port.npz"
        return mt.load_mps(str(path), device=device), path.name
    path = ROOT / "tests" / "data" / "reference_trained_ecg200.jld2"
    return mt.load_mpstime_jl(str(path), device=device), path.name


def _padded_weight(mps, d: int) -> float:
    """The largest share of the represented state's norm on the padded site
    directions (index >= d) of any one site.  Sites left of the center are
    left-orthogonal, so site t's share is its padded slice contracted with
    the right environment of sites t+1..T-1 (float64 on the card)."""
    cores, center = mps.cores.double(), mps.center.double()
    R = torch.einsum("aicl,bicl->ab", center, center.conj())
    worst = float(torch.einsum("aicl,aicl->", center[:, d:],
                               center[:, d:].conj()).real)
    for t in range(mps.T - 2, -1, -1):
        A = cores[t]
        worst = max(worst, float(torch.einsum(
            "aib,bc,aic->", A[:, d:], R, A[:, d:].conj()).real))
        R = torch.einsum("aib,bc,dic->ad", A, R, A.conj())
    return worst / float(torch.trace(R).real)


def _counts(bk) -> dict:
    """Nonzero launches and plain-version calls (the latter as plain_*)."""
    return {**_nonzero(bk.LAUNCHES),
            **{f"plain_{k}": v for k, v in _nonzero(bk.PLAIN_CALLS).items()}}


def port_api_phases(card: str) -> None:
    """Phases 28-33: the MPSTime.jl model, serialization, MPSClassifier,
    padded and batched fits, and tune / evaluate on the card."""
    import tempfile
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch.ops import bond_kernels as bk
    data = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    Xtr, ytr, Xte, yte = (data["X_train"], data["y_train"], data["X_test"],
                          data["y_test"])

    # ---- 28. the model MPSTime.jl trained, on the card in float64 ---------
    t_phase = time.perf_counter()
    ref, src = _reference_model(mt, "cuda")
    check(ref.mps.cores.is_cuda and ref.mps.dtype == torch.float64,
          f"reference model on {ref.mps.device} in {ref.mps.dtype}")
    tr_acc = float(np.mean(mt.classify(ref, Xtr) == ytr))
    te_acc = float(np.mean(mt.classify(ref, Xte) == yte))
    check(tr_acc == 1.0, f"reference model: train accuracy {tr_acc} != 1")
    check(abs(te_acc - REF_TEST_ACC) < 1e-12,
          f"reference model: test accuracy {te_acc} != {REF_TEST_ACC}")
    imp = mt.init_imputation_problem(ref, Xte, yte, verbosity=-1)
    sites = np.arange(30, 50)
    out = mt.mps_impute(imp, 0, 0, sites, method="median")
    mae = out[3][0]["MAE"]
    check(np.isfinite(out[0][0]).all(), "reference model: non-finite "
          "imputation")
    note = "at the pin"
    if abs(mae - REF_IMPUTE_MAE) > REF_MAE_RTOL * REF_IMPUTE_MAE:
        # a cumsum near-tie may move a site by one grid step: hold the card
        # against the CPU at that step, as the GPU imputation tests do
        from mpstime_tpu_torch.imputation.problem import get_predictions
        cpu_ref, _ = _reference_model(mt, "cpu")
        cpu_imp = mt.init_imputation_problem(cpu_ref, Xte, yte, verbosity=-1)
        a = get_predictions(imp, 0, 0, sites, "median",
                            invert_transform=False)[0][0]
        b = get_predictions(cpu_imp, 0, 0, sites, "median",
                            invert_transform=False)[0][0]
        steps = float(np.abs(a - b).max() / imp.dx)
        check(steps <= 1 + 1e-6, f"reference model: MAE {mae!r} != "
              f"{REF_IMPUTE_MAE!r} and the card is {steps:.2f} grid steps "
              "from the CPU")
        note = f"{mae - REF_IMPUTE_MAE:+.3e} off the pin, within one grid " \
            f"step of the CPU's ({steps:.2f} steps)"
    print(f"[reference-model-path] the ECG200 model MPSTime.jl trained "
          f"({src}) on cuda in float64: train accuracy {tr_acc:.4f}, test "
          f"accuracy {te_acc:.4f} (pin {REF_TEST_ACC}); median imputation "
          f"of instance 0, sites 30-49: MAE {mae!r} (pin {REF_IMPUTE_MAE!r}, "
          f"{note}); phase {time.perf_counter() - t_phase:.1f} s ({card})",
          flush=True)

    # ---- 29. save_mps -> load_mps on the card ------------------------------
    t_phase = time.perf_counter()
    trained, _, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
        verbosity=-1, log_level=-1), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model.npz")
        save_s, _ = _synced_s(lambda: mt.save_mps(path, trained))
        load_s, loaded = _synced_s(lambda: mt.load_mps(path, device="cuda"))
        size = Path(path).stat().st_size
    check(loaded.mps.cores.is_cuda and loaded.train_data.X_enc.is_cuda,
          "load_mps: the model is not on the card")
    check(mt.trained_mps_equal(trained, loaded, atol=0.0),
          "load_mps: the loaded model differs from the saved one")
    check(np.array_equal(mt.classify(loaded, Xte), mt.classify(trained, Xte)),
          "load_mps: the loaded model classifies differently")
    print(f"[serialize-path] default fit on cuda -> save_mps ({size} bytes, "
          f"{save_s:.3f} s) -> load_mps(device='cuda') ({load_s:.3f} s): "
          f"trained_mps_equal(atol=0) and classify of {len(Xte)} series "
          f"identical; phase {time.perf_counter() - t_phase:.1f} s ({card})",
          flush=True)

    # ---- 30. MPSClassifier at the default width ----------------------------
    # its own default is 5 sweeps; the main path's 10 hold it to that path's
    # floor
    t_phase = time.perf_counter()
    bk.reset_counts()
    clf = mt.MPSClassifier(nsweeps=10)
    fit_s, _ = _synced_s(lambda: clf.fit(Xtr, ytr))
    launches, plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    clf_acc = clf.score(Xte, yte)
    check(clf.trained_.mps.cores.is_cuda, "MPSClassifier: not on the card")
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k12m": 10 * 24}
    check(launches == want, f"MPSClassifier: launches {launches} != {want}")
    check(sum(plain.values()) == 0, f"MPSClassifier: plain calls {plain}")
    check(clf_acc >= ACC_FLOOR, f"MPSClassifier: test accuracy {clf_acc} < "
          f"{ACC_FLOOR}")
    print(f"[classifier-path] MPSClassifier(nsweeps=10) (chi 25, d 5, f32) "
          f"fit {fit_s:.2f} s, K12m launches {launches['k12m']}, score "
          f"(test accuracy) {clf_acc:.4f} (floor {ACC_FLOOR}); phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)

    # ---- 31. a padded fit: K1 -> QR -> K2 with the rank cap -----------------
    t_phase = time.perf_counter()
    bk.reset_counts()
    popts = mt.MPSOptions(chi_max=15, d=4, pad_to=(25, 5), verbosity=-1,
                          log_level=-1)
    pfit_s, (padded, pinfo, _) = _synced_s(
        lambda: mt.fit_mps(Xtr, ytr, opts=popts, device="cuda"))
    launches, plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    check(popts.resolved_orth_alg("cuda") == "qr", "pad_to did not force qr")
    c = padded.mps.cores
    T = c.shape[0]
    check(tuple(c.shape) == (T, 25, 5, 25), f"padded cores {tuple(c.shape)}")
    dims = padded.mps.bond_dims()
    check(int(dims.max()) <= 15, f"padded fit: bond dims {dims.max()} > 15")
    share = float((c[:, :, 4:, :].abs() ** 2).sum() / (c.abs() ** 2).sum())
    weight = _padded_weight(padded.mps, 4)
    check(weight < PAD_DEAD_WEIGHT, f"padded fit: the state's weight on the "
          f"padded directions {weight:.3e} >= {PAD_DEAD_WEIGHT}")
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k1": 10 * 190, "k2": 10 * 190}
    check(launches == want, f"padded fit: launches {launches} != {want}")
    check(sum(plain.values()) == 0, f"padded fit: plain calls {plain}")
    p_acc = float(np.mean(mt.classify(padded, Xte) == yte))
    ufit_s, (unpadded, uinfo, _) = _synced_s(lambda: mt.fit_mps(
        Xtr, ytr, opts=popts.replace(pad_to=None), device="cuda"))
    u_acc = float(np.mean(mt.classify(unpadded, Xte) == yte))
    check(p_acc >= PAD_ACC_FLOOR, f"padded fit: test accuracy {p_acc} < "
          f"{PAD_ACC_FLOOR}")
    print(f"[padded-path] MPSOptions(chi_max=15, d=4, pad_to=(25, 5)) on "
          f"cuda: cores {tuple(c.shape)}, bond dims <= {int(dims.max())}, "
          f"the state's weight on the padded site directions {weight:.2e} "
          f"(at most, a site; bound {PAD_DEAD_WEIGHT}), the cores' "
          f"squared entries there {share:.2e}; launches K1 {launches['k1']}, "
          f"K2 {launches['k2']}, no plain call; test accuracy {p_acc:.4f} "
          f"(unpadded chi 15, d 4: {u_acc:.4f}); fit {pfit_s:.2f} s, median "
          f"sweep {statistics.median(pinfo['sweep_seconds'][1:]):.4f} s "
          f"(unpadded {ufit_s:.2f} s, "
          f"{statistics.median(uinfo['sweep_seconds'][1:]):.4f} s); phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)

    # ---- 32. fit_mps_batch of 5 CV folds against 5 sequential fits --------
    t_phase = time.perf_counter()
    folds = mt.make_stratified_cvfolds(Xtr, ytr, 5, rng=1)
    jobs = [(Xtr[tr], ytr[tr]) for tr, _ in folds]
    bopts = mt.MPSOptions(verbosity=-1, log_level=-1)
    bk.reset_counts()
    batch_s, models = _synced_s(lambda: mt.fit_mps_batch(jobs, opts=bopts,
                                                         device="cuda"))
    b_counts = _counts(bk)
    bk.reset_counts()
    seq_s, seq = _synced_s(lambda: [mt.fit_mps(X, y, opts=bopts,
                                               device="cuda")[0]
                                    for X, y in jobs])
    s_counts = _counts(bk)
    check(b_counts.get("k12m", 0) > 0 and b_counts == s_counts
          and not any(k.startswith("plain_") for k in b_counts),
          f"fit_mps_batch launched {b_counts}, the sequential fits "
          f"{s_counts}")
    check(all(torch.equal(m.mps.cores, q.mps.cores)
              and torch.equal(m.mps.center, q.mps.center)
              for m, q in zip(models, seq)),
          "fit_mps_batch: a fold differs from its sequential fit_mps")
    b_acc = [float(np.mean(mt.classify(m, Xtr[va]) == ytr[va]))
             for m, (_, va) in zip(models, folds)]
    s_acc = [float(np.mean(mt.classify(m, Xtr[va]) == ytr[va]))
             for m, (_, va) in zip(seq, folds)]
    for m in models:
        check(m.mps.cores.is_cuda and bool(torch.isfinite(m.mps.center).all()),
              "fit_mps_batch: a model is not finite on the card")
    print(f"[batched-fit-path] fit_mps_batch of the 5 stratified folds of "
          f"ECG200 train (N {[len(tr) for tr, _ in folds]}, default "
          f"MPSOptions) on cuda: {batch_s:.2f} s, launches "
          f"{b_counts}, per-fold validation accuracy "
          f"{', '.join(f'{a:.3f}' for a in b_acc)}; 5 sequential fit_mps: "
          f"{seq_s:.2f} s, {', '.join(f'{a:.3f}' for a in s_acc)}, the same "
          f"launches and bits; phase {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)

    # ---- 33. evaluate and tune on the card ---------------------------------
    t_phase = time.perf_counter()
    Xs, ys = np.concatenate([Xtr, Xte]), np.concatenate([ytr, yte])
    params = {"chi_max": (15, 5, 25), "d": [4, 5]}
    bk.reset_counts()
    eval_s, res = _synced_s(lambda: mt.evaluate(
        Xs, ys, nfolds=5, tuning_parameters=params,
        objective=mt.MisclassificationRate(), n_cvfolds=2,
        tuning_maxiters=3, verbosity=-1, device="cuda"))
    e_counts = _counts(bk)
    N = len(ys)
    check(len(res) == 5, f"evaluate: {len(res)} folds")
    tests = np.concatenate([np.asarray(r["test_inds"]) for r in res])
    check(len(tests) == N and len(np.unique(tests)) == N,
          "evaluate: the test sets do not partition the data")
    for r in res:
        check(set(r) == EVAL_KEYS, f"evaluate: keys {sorted(r)}")
        tr, te = set(r["train_inds"].tolist()), set(r["test_inds"].tolist())
        # stratified folds: each class's share of a test set is the floor
        # or the ceiling of its count over 5
        check(not tr & te and len(tr) + len(te) == N
              and all(np.sum(ys[r["test_inds"]] == c) in (n // 5, n // 5 + 1)
                      for c, n in zip(*np.unique(ys, return_counts=True))),
              f"evaluate: fold {r['fold']} breaks the partition law")
        check(0.0 <= r["loss"] <= 1.0, f"evaluate: loss {r['loss']}")
        check(r["opts"].pad_to == (25, 5), f"evaluate: refit pad_to "
              f"{r['opts'].pad_to}")
    check(e_counts.get("k1", 0) > 0 and e_counts.get("k2", 0) > 0
          and not any(k.startswith("plain_") for k in e_counts),
          f"evaluate: counts {e_counts}")
    losses = [r["loss"] for r in res]
    print(f"[tune-evaluate-path] evaluate(ECG200 train+test, N {N}, nfolds=5, "
          f"MisclassificationRate, n_cvfolds=2, tuning_maxiters=3, "
          f"chi_max (15, 5, 25), d [4, 5] -> pad_to (25, 5), f32) on cuda: "
          f"{eval_s:.1f} s, mean loss {np.mean(losses):.4f} (per fold "
          f"{', '.join(f'{v:.3f}' for v in losses)}); launches K1 "
          f"{e_counts.get('k1', 0)}, K2 {e_counts.get('k2', 0)}, K12m "
          f"{e_counts.get('k12m', 0)}, no plain call; test sets of "
          f"{[len(r['test_inds']) for r in res]}, the 13 keys and the "
          f"partition law held ({card})", flush=True)
    bk.reset_counts()
    tune_s, (best, cache) = _synced_s(lambda: mt.tune(
        Xtr, ytr, 5, params, objective=mt.ImputationLoss(), pms=[0.2],
        maxiters=2, fold_batch=True, verbosity=-1, device="cuda"))
    t_counts = _counts(bk)
    check(len(cache) == 2 and all(np.isfinite(v) for v in cache.values()),
          f"tune(fold_batch=True): cache {cache}")
    check(t_counts.get("k1", 0) > 0 and t_counts.get("k2", 0) > 0
          and not any(k.startswith("plain_") for k in t_counts),
          f"tune(fold_batch=True): counts {t_counts}")
    print(f"[tune-evaluate-path] tune(ECG200 train, 5 folds, ImputationLoss "
          f"(pms [0.2], median, dx 1e-4), maxiters=2, fold_batch=True) on "
          f"cuda: {tune_s:.1f} s; best {best}; cache "
          f"{ {k: round(v, 4) for k, v in cache.items()} }; launches K1 "
          f"{t_counts.get('k1', 0)}, K2 {t_counts.get('k2', 0)}, no plain "
          f"call (each trial's 5 folds one fit_mps_batch at the padded caps, "
          f"then impute_windows); phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)

SHAPE3 = dict(C=3, chi=25, d=5, N=90)     # trendysine: 3 classes, 90 series
# trendysine at the default options on the CPU (1 thread), init seeds 1234,
# 1, 2: the port's and the JAX package's train / test accuracy
TS3_CPU_PORT = {1234: (0.744, 0.456), 1: (0.733, 0.389), 2: (0.878, 0.578)}
TS3_CPU_JAX = {1234: (0.678, 0.444), 1: (0.633, 0.344), 2: (0.978, 0.722)}
TS3_TRAIN_ACC_FLOOR = 0.60       # mean over the three seeds; chance is 1/3
NAIVE_AGREEMENT = 0.95           # tests/test_reference_engine.py:45


def two_class_sines():
    """The JAX package's test problem (tests/conftest.py:66-82): sinusoids
    of frequency 1 and 6 with random phase and noise, T 48."""
    rng = np.random.default_rng(42)
    T, n_per = 48, 40

    def make(freq, n):
        t = np.linspace(0, 2 * np.pi, T)
        ph = rng.uniform(0, 2 * np.pi, size=(n, 1))
        return (np.sin(freq * t[None, :] + ph)
                + 0.05 * rng.standard_normal((n, T)))

    X = np.concatenate([make(1.0, n_per), make(6.0, n_per)], axis=0)
    y = np.concatenate([np.zeros(n_per, int), np.ones(n_per, int)])
    perm = rng.permutation(2 * n_per)
    X, y = X[perm], y[perm]
    return X[:48], y[:48], X[48:], y[48:]


def _encoded(mt, Xtr, ytr, Xte, yte, opts, device):
    """The training and test sets encoded as fit_mps encodes them."""
    from mpstime_tpu_torch.utils.preprocessing import transform_data
    Xtr_s, Xte_s, _, _ = transform_data(Xtr, Xte, opts)
    tr = mt.encode_dataset(Xtr, Xtr_s, ytr, opts, device=device)
    te = mt.encode_dataset(Xte, Xte_s, yte, opts, labels=tr.labels,
                           training_enc_args=tr.enc_args, device=device)
    return tr, te


def _naive_vs_card(mt, opts, data, C):
    """The port's fit on the card and the naive engine on the host, on the
    same encoded data: (card test accuracy, naive test accuracy, their
    agreement, naive seconds)."""
    from mpstime_tpu_torch.training.reference_engine import (naive_fit_mps,
                                                             naive_predict)
    from mpstime_tpu_torch.training.stats import predict_class_indices
    Xtr, ytr, Xte, yte = data
    tr, te = _encoded(mt, Xtr, ytr, Xte, yte, opts, "cuda")
    trained, _, _ = mt.fit_mps(Xtr, ytr, opts=opts, device="cuda")
    check(trained.mps.cores.is_cuda and bool(
        torch.isfinite(trained.mps.center).all()), "naive vs card: the "
        "card's fit is not finite on the card")
    fast = predict_class_indices(trained.mps, te.X_enc)
    t0 = time.perf_counter()
    naive = naive_fit_mps(tr.X_enc.cpu().numpy(), tr.y_idx, C,
                          nsweeps=opts.nsweeps, chi_max=opts.chi_max,
                          chi_init=opts.chi_init, eta=opts.eta,
                          cutoff=opts.cutoff, seed=opts.init_rng)
    slow = naive_predict(naive, te.X_enc.cpu().numpy())
    naive_s = time.perf_counter() - t0
    return (float(np.mean(fast == te.y_idx)), float(np.mean(slow == te.y_idx)),
            float(np.mean(fast == slow)), naive_s)


def _trace_ms_under(trace_path, kernel: str, ranges):
    """Device ms of the kernels whose name holds ``kernel`` under each
    named range of a torch.profiler trace, with the count of such
    kernels in the whole trace: each kernel's launch (the runtime or driver
    call with its correlation id) is placed in the host range that holds
    it."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel in e.get("name", "")]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    spans = {r: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == r]
             for r in ranges}
    ms = dict.fromkeys(ranges, 0.0)
    n = dict.fromkeys(ranges, 0)
    for k in kernels:
        ts = launch_ts.get(k.get("args", {}).get("correlation"))
        for r in ranges:
            if ts is not None and any(a <= ts <= b for a, b in spans[r]):
                ms[r] += k["dur"] / 1e3
                n[r] += 1
    return ms, n, len(kernels), {r: len(v) for r, v in spans.items()}


def last_slice_phases(card: str) -> None:
    """Phases 34-37: the UCR loader, the three-class path, the naive
    reference engine and the profiling path on the card."""
    import tempfile
    import mpstime_tpu_torch as mt
    from mpstime_tpu_torch import training
    from mpstime_tpu_torch.ops import bond_kernels as bk
    from mpstime_tpu_torch.training import sweep as tsweep
    from mpstime_tpu_torch.utils import data_loading as dl
    from mpstime_tpu_torch.utils.profiling import TRACE_FILE, profile_trace
    data = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    Xtr, ytr, Xte, yte = (data["X_train"], data["y_train"], data["X_test"],
                          data["y_test"])

    # ---- 34. the UCR loader ------------------------------------------------
    t0 = time.perf_counter()
    check(dl._get_native() is not None, "UCR loader: the native parser did "
          "not build (g++)")
    build_s = time.perf_counter() - t0
    ts3 = {}
    for split in ("TRAIN", "TEST"):
        X, y = dl.load_ucr_file(ROOT / "tests" / "data"
                                / f"trendysine_{split}.tsv")
        check(X.shape == (90, 60) and X.dtype == np.float64
              and y.dtype == np.int64
              and np.bincount(y).tolist() == [30, 30, 30],
              f"trendysine {split}: {X.shape} {X.dtype} {y.dtype} "
              f"{np.bincount(y).tolist()}")
        ts3[split] = (X, y)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ecg200_TRAIN.txt"
        with open(path, "w") as f:
            for x, lab in zip(Xtr, ytr):
                f.write(" ".join([str(int(lab))] + [repr(float(v)) for v in x])
                        + "\n")
        X, y = dl.load_ucr_file(path)
    check(np.array_equal(X, Xtr) and np.array_equal(y, ytr)
          and y.dtype == np.int64, "UCR loader: ECG200 written with repr "
          "floats did not read back bit for bit")
    print(f"[loader-path] native parser {dl.library_path().name} built and "
          f"loaded in {build_s:.2f} s; trendysine TRAIN/TEST (90, 60) each, "
          f"labels int64, 30/30/30; ECG200 train written with repr floats "
          f"read back bit for bit ({card})", flush=True)

    # ---- 35. the three-class path ---------------------------------------
    err3, n3 = k12_k12m_vs_plain(bk, SHAPE3, 3100)
    print(f"[three-class-kernels] C=3, chi 25, d 5, N 90: K12 {n3['k12']} "
          f"cases, max |err| {err3['k12']:.3e}; K12m {n3['k12m']} cases, max "
          f"|err| {err3['k12m']:.3e} (rtol {RTOL}, atol {ATOL}; K12m vs "
          f"chained K12 atol {CHAIN_ATOL}); kept ranks equal ({card})",
          flush=True)
    (X3, y3), (X3t, y3t) = ts3["TRAIN"], ts3["TEST"]
    accs = {}
    for seed in (1234, 1, 2):
        bk.reset_counts()
        tr, inf, _ = mt.fit_mps(X3, y3, opts=mt.MPSOptions(
            verbosity=-1, log_level=-1, init_rng=seed), device="cuda")
        torch.cuda.synchronize()
        counts = _counts(bk)
        check(counts == {"k12m": 10 * 16}, f"trendysine fit (seed {seed}): "
              f"counts {counts} != K12m 160 (8 blocks a half-sweep of 59 "
              f"bonds), no plain call")
        for t in (tr.mps.cores, tr.mps.center):
            check(t.is_cuda and bool(torch.isfinite(t).all()),
                  f"trendysine fit (seed {seed}): weights not finite on "
                  f"the card")
        accs[seed] = (float(np.mean(mt.classify(tr, X3) == y3)),
                      float(np.mean(mt.classify(tr, X3t) == y3t)),
                      sum(inf["sweep_seconds"]))
    mean_train = float(np.mean([a[0] for a in accs.values()]))
    check(mean_train >= TS3_TRAIN_ACC_FLOOR, f"trendysine: mean train "
          f"accuracy {mean_train:.4f} < {TS3_TRAIN_ACC_FLOOR}")
    print("[three-class-path] trendysine (C 3, N 90, T 60) at the default "
          "MPSOptions on cuda, K12m 160 a fit, no plain call; init seed: "
          "train / test accuracy on the card [port on the CPU; JAX on the "
          "CPU], fit s: " + "; ".join(
              f"{s}: {a[0]:.4f} / {a[1]:.4f} [{TS3_CPU_PORT[s][0]} / "
              f"{TS3_CPU_PORT[s][1]}; {TS3_CPU_JAX[s][0]} / "
              f"{TS3_CPU_JAX[s][1]}], {a[2]:.3f} s"
              for s, a in accs.items())
          + f"; mean train accuracy {mean_train:.4f} (floor "
          f"{TS3_TRAIN_ACC_FLOOR}) ({card})", flush=True)

    # ---- 36. the naive reference engine -----------------------------------
    Xs, ys, Xst, yst = two_class_sines()
    opts = mt.MPSOptions(nsweeps=4, chi_max=8, d=3, verbosity=-1,
                         log_level=-1, dtype="float64", svd_alg="gram_eigh")
    bk.reset_counts()
    card_acc, naive_acc, agree, naive_s = _naive_vs_card(
        mt, opts, (Xs[:24], ys[:24], Xst[:24], yst[:24]), 2)
    check(sum(bk.LAUNCHES.values()) == sum(bk.PLAIN_CALLS.values()) == 0,
          f"naive vs card: the float64 fit ran a kernel or a plain version "
          f"({_counts(bk)})")
    check(agree >= NAIVE_AGREEMENT, f"naive vs card: agreement {agree:.4f} "
          f"< {NAIVE_AGREEMENT}")
    ts_opts = mt.MPSOptions(nsweeps=5, chi_max=20, d=4, verbosity=-1,
                            log_level=-1, dtype="float64",
                            svd_alg="gram_eigh")
    ts_card, ts_naive, ts_agree, ts_naive_s = _naive_vs_card(
        mt, ts_opts, (X3, y3, X3t, y3t), 3)
    # one sweep through training.full_sweep equals sweep_once bit for bit
    # (the default float32 route: K12m blocks)
    opts32 = mt.MPSOptions(verbosity=-1, log_level=-1)
    enc, _ = _encoded(mt, Xtr, ytr, Xte[:0], yte[:0], opts32, "cuda")
    m = mt.random_mps(opts32.init_rng, Xtr.shape[1], 5, 2, opts32.chi_init,
                      25, dtype=np.float32, device="cuda")
    phis = enc.X_enc.conj().transpose(0, 1).contiguous()
    y1h = torch.nn.functional.one_hot(
        torch.as_tensor(enc.y_idx, device="cuda"), 2).float()
    w = torch.full((len(ytr),), 1.0 / len(ytr), device="cuda")
    kw = dict(loss="KLD", bbopt="TSGO", update_iters=1, rescale=(False, True),
              svd_alg="randomized_warm", orth="ns")
    bk.reset_counts()
    cores, center = training.full_sweep(m.cores, m.center, phis, y1h, w,
                                        opts32.eta, opts32.cutoff, **kw)
    once = tsweep.sweep_once(m.cores, m.center, phis, y1h, w, opts32.eta,
                             opts32.cutoff, **kw)
    torch.cuda.synchronize()
    fs_counts = _counts(bk)
    check(torch.equal(cores, once[0]) and torch.equal(center, once[1]),
          "full_sweep on cuda differs from sweep_once")
    check(fs_counts == {"k12m": 2 * 24}, f"full_sweep: counts {fs_counts}")
    print(f"[reference-engine-path] two_class_sines (N 24, chi 8, d 3, 4 "
          f"sweeps, float64, gram_eigh): the card's fit (unfused, "
          f"cuSOLVER) {card_acc:.4f} test accuracy, the naive engine "
          f"{naive_acc:.4f} ({naive_s:.1f} s on the host), agreement "
          f"{agree:.4f} (>= {NAIVE_AGREEMENT}); trendysine (5 sweeps, chi "
          f"20, d 4, float64): the card {ts_card:.4f}, the naive engine "
          f"{ts_naive:.4f} in {ts_naive_s:.1f} s, agreement {ts_agree:.4f} "
          f"(no threshold); training.full_sweep on cuda equals sweep_once "
          f"bit for bit (K12m 24 each) ({card})", flush=True)

    # ---- 37. the profiling path -------------------------------------------
    ranges = SCOPES
    with tempfile.TemporaryDirectory() as tmp:
        bk.reset_counts()
        with profile_trace(tmp):
            _, p_info, _ = mt.fit_mps(
                Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                             nsweeps=2), device="cuda")
        trace = Path(tmp) / TRACE_FILE
        check(trace.is_file(), f"profile_trace wrote no {TRACE_FILE}")
        size = trace.stat().st_size
        ms, n, n_k12m, n_spans = _trace_ms_under(trace, "k12m_cluster_kernel",
                                                 ranges)
    check(n_k12m == 2 * 24 == bk.LAUNCHES["k12m"], f"profile: {n_k12m} "
          f"k12m_cluster_kernel events in the trace, {bk.LAUNCHES['k12m']} "
          f"launches, want 48")
    check(all(n_spans[r] == 2 for r in ranges), f"profile: ranges {n_spans}, "
          "want 2 of each")
    check(all(n[r] == 24 for r in ranges), f"profile: K12m launches under "
          f"the ranges {n}, want 24 each")
    print(f"[profile-trace-path] profile_trace around a two-sweep default "
          f"ECG200 fit on cuda: {TRACE_FILE} {size} bytes, "
          f"{n_k12m} k12m_cluster_kernel events, ranges {n_spans}; K12m "
          f"device ms under mps/backward_bond {ms[ranges[0]]:.2f} "
          f"({n[ranges[0]]} launches), under mps/forward_bond "
          f"{ms[ranges[1]]:.2f} ({n[ranges[1]]}); sweep wall "
          f"{1e3 * sum(p_info['sweep_seconds']):.1f} ms ({card})",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "mpstime_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: mpstime_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # ---- 1. device --------------------------------------------------------
    card = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    from mpstime_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.load_library()
    print(f"[build] {build.library_path().relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.last_build_seconds:.2f} s)", flush=True)

    ptxas = ptxas_summary(build.build_log)
    print(f"[ptxas] {ptxas}", flush=True)
    from mpstime_tpu_torch.ops import bond_kernels as bk
    from mpstime_tpu_torch.ops import bond_kernels_c as bkc
    from mpstime_tpu_torch.ops.decomp import _qr_orth

    # ---- 3. kernel vs plain ----------------------------------------------
    err, n_cases = k12_k12m_vs_plain(bk, SHAPE, 100)
    tb = tie_break_inputs()
    kw = dict(forward=False, refresh=False, power_iters=1)
    got = bk.k12_cuda(*tb, **kw)
    ref = bk.k12_plain(*tb, **kw)
    err["k12"] = max(err["k12"], compare("K12 tie-break", got, ref,
                                         False))
    kept_dirs = kept(got[1], False).tolist()
    check(kept_dirs == [True, True, True, False, False, False],
          f"tie-break kept {kept_dirs}")
    print(f"[kernel-vs-plain] K12 {n_cases['k12']} cases + tie-break, max "
          f"|err| {err['k12']:.3e}; K12m {n_cases['k12m']} cases, max |err| "
          f"{err['k12m']:.3e} (rtol {RTOL}, atol {ATOL}; K12m vs chained "
          f"K12 atol {CHAIN_ATOL}); kept ranks equal", flush=True)

    # K1 over its grid: BT and Y (the column-normalised iterate under
    # orth="qr", before any QR)
    err["k1"] = err["k2"] = 0.0
    n_cases["k1"] = n_cases["k2"] = 0
    k1_grid = [(f, e, q, loss, bbopt) for f in (False, True)
               for e in (True, False) for q in (1, 3)
               for loss in ("KLD", "MSE") for bbopt in ("TSGO", "GD")]
    for i, (forward, emit_y, q, loss, bbopt) in enumerate(k1_grid):
        x = bond_inputs(300 + i, 1, **SHAPE)
        args = k1_args(x, forward)
        kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth="qr",
                  loss=loss, bbopt=bbopt)
        got = bk.k1_cuda(*args, **kw)
        torch.cuda.synchronize()
        ref = bk.k1_plain(*args, **kw)
        err["k1"] = max(err["k1"], compare_all(f"K1 {kw}", got, ref))
        n_cases["k1"] += 1
    for i, (forward, mr) in enumerate((f, m) for f in (False, True)
                                      for m in (None, 17)):
        args = k2_args(bk, bond_inputs(400 + i, 1, **SHAPE), forward)
        got = bk.k2_cuda(*args, forward=forward, max_rank=mr)
        torch.cuda.synchronize()
        ref = bk.k2_plain(*args, forward=forward, max_rank=mr)
        name = f"K2 {'fwd' if forward else 'bwd'} max_rank={mr}"
        err["k2"] = max(err["k2"], compare(name, got, ref, forward))
        n_cases["k2"] += 1
    # the tie-break case fed to K2: its bond tensor (eta 0) and the basis
    A, center, le, re, ls, phil, phir, y1h, w, V0, _, cutoff = tb
    BT, _ = bk.k1_plain(A, center, le, re, phil, phir, y1h, w, ls, V0, 0.0,
                        forward=False, emit_y=False)
    got = bk.k2_cuda(BT, V0, re, ls, phir, cutoff, forward=False)
    ref = bk.k2_plain(BT, V0, re, ls, phir, cutoff, forward=False)
    err["k2"] = max(err["k2"], compare("K2 tie-break", got, ref, False))
    kept_dirs = kept(got[1], False).tolist()
    check(kept_dirs == [True, True, True, False, False, False],
          f"K2 tie-break kept {kept_dirs}")
    # a whole QR bond: both sides orthonormalise with torch.linalg.qr
    qr_err = 0.0
    for i, (forward, loss) in enumerate((f, l) for f in (False, True)
                                        for l in ("KLD", "MSE")):
        x = bond_inputs(500 + i, 1, **SHAPE)
        kw = dict(forward=forward, loss=loss,
                  opp_ls=x["opp"] if loss == "MSE" else None)
        got = bk.qr_bond_step(*k12_args(x, forward), plain=False, **kw)
        torch.cuda.synchronize()
        ref = bk.qr_bond_step(*k12_args(x, forward), plain=True, **kw)
        qr_err = max(qr_err, compare(f"QR bond {kw['forward']} {loss}", got,
                                     ref, forward))
    print(f"[kernel-vs-plain] K1 {n_cases['k1']} cases, max |err| "
          f"{err['k1']:.3e}; K2 {n_cases['k2']} cases + tie-break (kept "
          f"directions 0..2), max |err| {err['k2']:.3e}; QR bond (K1 -> "
          f"torch.linalg.qr -> K2) 4 cases, max |err| {qr_err:.3e} (rtol "
          f"{RTOL}, atol {ATOL}); kept ranks equal", flush=True)

    x1 = bond_inputs(7, 1, **SHAPE)
    x8 = bond_inputs(8, 8, **SHAPE)
    kw1 = dict(forward=False, refresh=True, power_iters=1)
    times = {
        "k12": (time_ms(lambda: bk.k12_cuda(*k12_args(x1, False), **kw1)),
                time_ms(lambda: bk.k12_plain(*k12_args(x1, False), **kw1))),
        "k12m": (time_ms(lambda: bk.k12m_cuda(*k12m_args(x8), **kw1)),
                 time_ms(lambda: bk.k12m_plain(*k12m_args(x8), **kw1))),
    }
    print(f"[timing] one refresh bond (K12) {times['k12'][0]:.3f} ms vs plain "
          f"{times['k12'][1]:.3f} ms; an 8-bond block (K12m) "
          f"{times['k12m'][0]:.3f} ms vs plain {times['k12m'][1]:.3f} ms "
          f"({card})", flush=True)
    a1 = k1_args(x1, False)
    BT1, Y1 = bk.k1_cuda(*a1, forward=False)
    Q1 = torch.linalg.qr(Y1).Q.contiguous()
    a2 = (BT1, Q1, x1["envx"][0], x1["ls0"], x1["phir"][0], 1e-10)
    times["k1"] = (time_ms(lambda: bk.k1_cuda(*a1, forward=False)),
                   time_ms(lambda: bk.k1_plain(*a1, forward=False)))
    times["k2"] = (time_ms(lambda: bk.k2_cuda(*a2, forward=False)),
                   time_ms(lambda: bk.k2_plain(*a2, forward=False)))
    qr_ms = time_ms(lambda: torch.linalg.qr(Y1))
    print(f"[timing] one qr refresh bond: K1 {times['k1'][0]:.3f} ms vs plain "
          f"{times['k1'][1]:.3f} ms; torch.linalg.qr of Y "
          f"{list(Y1.shape)} {qr_ms:.3f} ms; K2 {times['k2'][0]:.3f} ms vs "
          f"plain {times['k2'][1]:.3f} ms ({card})", flush=True)

    # ---- 4. main path -----------------------------------------------------
    import mpstime_tpu_torch as mt
    data = np.load(ROOT / "tests" / "data" / "ecg200.npz")
    Xtr, ytr, Xte, yte = (data["X_train"], data["y_train"], data["X_test"],
                          data["y_test"])
    # the default fit (KLD) runs K12m blocks; its counts are read from its
    # own run alone
    bk.reset_counts()
    trained, info, _ = mt.fit_mps(Xtr, ytr, Xte, yte,
                                  mt.MPSOptions(verbosity=-1, log_level=-1),
                                  device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = mt.classify(trained, Xte)
    torch.cuda.synchronize()
    classify_s = time.perf_counter() - t0
    launches, plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    acc = float(np.mean(preds == yte))
    m = trained.mps
    check(m.cores.is_cuda and m.center.is_cuda, "model not on the card")
    check(tuple(m.center.shape) == (25, 5, 25, 2), f"center {m.center.shape}")
    for t in (m.cores, m.center):
        check(bool(torch.isfinite(t).all()), "non-finite model weights")
    # one cluster K12m a block of bonds: 24 a sweep, never the one-block one
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k12m": 10 * 24}
    check(launches == want, f"default fit: launches {launches} != {want}")
    check(sum(plain.values()) == 0,
          f"default fit: plain-version calls on the card {plain}")
    check(acc >= ACC_FLOOR, f"test accuracy {acc} < {ACC_FLOOR}")
    sweep_s = statistics.median(info["sweep_seconds"][1:])
    print(f"[main-path] ECG200 default MPSOptions (KLD, 10 sweeps) on cuda: "
          f"test accuracy {acc:.4f}; median sweep {sweep_s:.4f} s (after 1 "
          f"warm sweep); classify {classify_s:.4f} s for {len(Xte)} series; "
          f"launches {launches}; plain calls {plain} ({card})", flush=True)

    # an MSE fit through the same entry point runs one K12 per bond; its
    # counts are read from its own run alone
    bk.reset_counts()
    mse_trained, mse_info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                     loss_grad="MSE", nsweeps=2),
        device="cuda")
    mse_preds = mt.classify(mse_trained, Xte)
    torch.cuda.synchronize()
    mse_launches, mse_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    check(bool(torch.isfinite(mse_trained.mps.center).all()),
          "MSE fit: non-finite model weights")
    check(set(np.unique(mse_preds)) <= set(np.unique(ytr)),
          "MSE-fit predictions outside the label set")
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k12": 2 * 190}
    check(mse_launches == want, f"MSE fit: launches {mse_launches} != "
          f"{want}")
    check(sum(mse_plain.values()) == 0,
          f"MSE fit: plain-version calls on the card {mse_plain}")
    print(f"[main-path] ECG200 MPSOptions(loss_grad='MSE', nsweeps=2) on "
          f"cuda: test accuracy {float(np.mean(mse_preds == yte)):.4f}; "
          f"sweeps {[round(t, 4) for t in mse_info['sweep_seconds']]} s; "
          f"launches {mse_launches}; plain calls {mse_plain} ({card})",
          flush=True)

    # the default fit's accuracy over other init seeds (reported, not held
    # to the floor: the floor is the default seed's)
    seed_acc = {}
    for seed in (1, 2):
        tr, inf, _ = mt.fit_mps(
            Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                         init_rng=seed), device="cuda")
        seed_acc[seed] = (float(np.mean(mt.classify(tr, Xte) == yte)),
                          statistics.median(inf["sweep_seconds"][1:]))
    print("[seeds] ECG200 default MPSOptions on cuda, init_rng: test accuracy, "
          "median sweep s: " + "; ".join(
              f"{s}: {a:.4f}, {t:.4f}" for s, (a, t) in seed_acc.items())
          + f" ({card})", flush=True)

    # where a default sweep's device time goes: two sweeps under
    # torch.profiler (sums of each device kernel's own time)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_info, _ = mt.fit_mps(
            Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                         nsweeps=2), device="cuda")
        torch.cuda.synchronize()
    dev = device_ms(prof)
    busy, wall = sum(dev.values()), 1e3 * sum(prof_info["sweep_seconds"])
    check(not any("k12m_kernel" in k for k in dev),
          f"default fit profile: a one-block K12m ran: {list(dev)}")
    k12m_ms = sum(v for k, v in dev.items() if "k12m_cluster_kernel" in k)
    print(f"[profile] default fit, two sweeps on cuda: device busy "
          f"{busy:.1f} ms of {wall:.1f} ms sweep wall time "
          f"({100 * busy / wall:.1f} %); K12m (cluster) {k12m_ms:.1f} ms; "
          "by kernel: " + "; ".join(
              f"{k[:60]} {v:.1f} ms"
              for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:5])
          + f" ({card})", flush=True)

    # ---- 5. qr path ------------------------------------------------------
    # orth="qr" with a refresh every second sweep: refresh sweeps run
    # K1 -> QR -> K2 bond by bond, frozen sweeps K12m blocks; the counts
    # are read from this run alone
    bk.reset_counts()
    qr_trained, qr_info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                     orth_alg="qr", subspace_refresh_every=2),
        device="cuda")
    qr_preds = mt.classify(qr_trained, Xte)
    torch.cuda.synchronize()
    qr_launches, qr_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    qr_acc = float(np.mean(qr_preds == yte))
    m = qr_trained.mps
    check(m.cores.is_cuda and m.center.is_cuda, "qr fit: model not on the card")
    for t in (m.cores, m.center):
        check(bool(torch.isfinite(t).all()), "qr fit: non-finite weights")
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k12m": 5 * 24, "k1": 5 * 190,
            "k2": 5 * 190}
    check(qr_launches == want, f"qr fit: launches {qr_launches} != {want}")
    check(sum(qr_plain.values()) == 0, f"qr fit: plain calls {qr_plain}")
    check(qr_acc >= QR_ACC_FLOOR, f"qr fit: test accuracy {qr_acc} < "
          f"{QR_ACC_FLOOR}")
    secs = qr_info["sweep_seconds"]
    refresh_s = statistics.median(secs[2::2])     # after the first sweep
    frozen_s = statistics.median(secs[1::2])
    print(f"[qr-path] ECG200 MPSOptions(orth_alg='qr', "
          f"subspace_refresh_every=2) on cuda: test accuracy {qr_acc:.4f}; "
          f"median refresh sweep {refresh_s:.4f} s, frozen sweep "
          f"{frozen_s:.4f} s; launches {qr_launches}; plain calls {qr_plain} "
          f"({card})", flush=True)

    # where a qr fit's device time goes: one refresh and one frozen sweep
    # under torch.profiler (sums of each device kernel's own time)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_info, _ = mt.fit_mps(
            Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1,
                                         orth_alg="qr", nsweeps=2,
                                         subspace_refresh_every=2),
            device="cuda")
        torch.cuda.synchronize()
    dev = device_ms(prof)
    busy = sum(dev.values())
    wall = 1e3 * sum(prof_info["sweep_seconds"])
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    # a fit launches K12m, K1 and K2 over a cluster only, never on one block
    check(not any(n in k for k in dev
                  for n in ("k12m_kernel", "k1_kernel", "k2_kernel")),
          f"qr fit profile: a one-block K12m, K1 or K2 ran: {list(dev)}")
    print(f"[profile] qr fit, one refresh + one frozen sweep on cuda: device "
          f"busy {busy:.1f} ms of {wall:.1f} ms sweep wall time; K12m "
          f"(cluster) "
          f"{sum(v for k, v in dev.items() if 'k12m_cluster_kernel' in k):.1f}"
          " ms; K1 (cluster) "
          f"{sum(v for k, v in dev.items() if 'k1_cluster_kernel' in k):.1f}"
          " ms; K2 (cluster) "
          f"{sum(v for k, v in dev.items() if 'k2_cluster_kernel' in k):.1f}"
          " ms; by kernel: "
          + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top)
          + f" ({card})", flush=True)

    # ---- 6. unfused path --------------------------------------------------
    bk.reset_counts()
    uf_trained, uf_info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(verbosity=-1, log_level=-1, nsweeps=2,
                                     svd_alg="gram_eigh", track_cost=True),
        device="cuda")
    uf_preds = mt.classify(uf_trained, Xte)
    torch.cuda.synchronize()
    uf_launches, uf_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    m = uf_trained.mps
    check(sum(uf_launches.values()) == 0, f"unfused fit: launches "
          f"{uf_launches}")
    check(sum(uf_plain.values()) == 0, f"unfused fit: plain calls {uf_plain}")
    check(m.cores.is_cuda and m.center.is_cuda,
          "unfused fit: model not on the card")
    for t in (m.cores, m.center):
        check(bool(torch.isfinite(t).all()), "unfused fit: non-finite weights")
    check(len(uf_info["bond_costs"][0]) == 190,
          f"unfused fit: {len(uf_info['bond_costs'][0])} bond costs")
    check(bool(np.isfinite(uf_info["bond_costs"][-1]).all()),
          "unfused fit: non-finite bond costs")
    print(f"[unfused-path] ECG200 MPSOptions(svd_alg='gram_eigh', nsweeps=2, "
          f"track_cost=True) on cuda: test accuracy "
          f"{float(np.mean(uf_preds == yte)):.4f}; sweeps "
          f"{[round(t, 4) for t in uf_info['sweep_seconds']]} s; launches "
          f"{uf_launches}; plain calls {uf_plain} ({card})", flush=True)

    # ---- 7. complex kernels ----------------------------------------------
    cerr = {"k12c": 0.0, "k12mc": 0.0, "k1c": 0.0, "k2c": 0.0}
    k12c_grid = [(f, r, q, mr) for f in (False, True)
                 for r, q, mr in ((True, 1, None), (True, 3, None),
                                  (False, 1, None), (True, 3, 17))]
    for i, (forward, refresh, q, mr) in enumerate(k12c_grid):
        x = bond_inputs_c(600 + i, 1, **SHAPE)
        kw = dict(forward=forward, refresh=refresh, power_iters=q,
                  max_rank=mr)
        got = bkc.k12c_cuda(*k12_args(x, forward), **kw)
        torch.cuda.synchronize()
        ref = bkc.k12c_plain(*k12_args(x, forward), **kw)
        cerr["k12c"] = max(cerr["k12c"], compare(f"K12c {kw}", got, ref,
                                                 forward))
    for i, (forward, refresh) in enumerate((f, r) for f in (False, True)
                                           for r in (True, False)):
        x = bond_inputs_c(700 + i, 4, **SHAPE)
        kw = dict(forward=forward, refresh=refresh, power_iters=1)
        name = f"K12mc Bb=4 {'fwd' if forward else 'bwd'} refresh={refresh}"
        got = bkc.k12mc_cuda(*k12m_args(x), **kw)
        torch.cuda.synchronize()
        ref = bkc.k12mc_plain(*k12m_args(x), **kw)
        cerr["k12mc"] = max(cerr["k12mc"], compare(name, got, ref, forward))
        center, env, ls, chain = x["center"], x["env0"], x["ls0"], []
        for b in range(4):
            le, re = (env, x["envx"][b]) if forward else (x["envx"][b], env)
            center, core, env, ls, Q = bkc.k12c_cuda(
                x["A"][b], center, le, re, ls, x["phil"][b], x["phir"][b],
                x["y1h"], x["w"], x["V0"][b], 0.05, 1e-10, **kw)
            chain.append((core, env, ls, Q))
        chained = (center,) + tuple(torch.stack(c) for c in zip(*chain))
        compare(name + " vs chained K12c", got, chained, forward,
                atol=CHAIN_ATOL, rtol=0.0)
    print(f"[kernel-vs-plain] K12c {len(k12c_grid)} cases, max |err| "
          f"{cerr['k12c']:.3e}; K12mc Bb=4 4 cases, max |err| "
          f"{cerr['k12mc']:.3e} (rtol {RTOL}, atol {ATOL}; K12mc vs chained "
          f"K12c atol {CHAIN_ATOL}); kept ranks equal", flush=True)
    for i, (forward, emit_y, q, orth) in enumerate(
            (f, e, q, o) for f in (False, True)
            for e, q, o in ((True, 1, "qr"), (True, 3, "qr"),
                            (False, 1, "qr"), (True, 3, "ns"))):
        x = bond_inputs_c(800 + i, 1, **SHAPE)
        args = k1c_args(x, forward)
        kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth)
        got = bkc.k1c_cuda(*args, **kw)
        torch.cuda.synchronize()
        ref = bkc.k1c_plain(*args, **kw)
        cerr["k1c"] = max(cerr["k1c"], compare_all(f"K1c {kw}", got, ref))
    for i, (forward, mr) in enumerate((f, m) for f in (False, True)
                                      for m in (None, 17)):
        x = bond_inputs_c(900 + i, 1, **SHAPE)
        a1 = k1c_args(x, forward)
        BT, Y = bkc.k1c_plain(*a1, forward=forward, power_iters=3)
        Q = _qr_orth(Y).contiguous()
        le, re = a1[2], a1[3]
        env, phi = (le, x["phil"][0]) if forward else (re, x["phir"][0])
        args = (BT, Q, env, x["ls0"], phi, 1e-10)
        got = bkc.k2c_cuda(*args, forward=forward, max_rank=mr)
        torch.cuda.synchronize()
        ref = bkc.k2c_plain(*args, forward=forward, max_rank=mr)
        cerr["k2c"] = max(cerr["k2c"], compare(
            f"K2c {'fwd' if forward else 'bwd'} max_rank={mr}", got, ref,
            forward))
    cqr_err = 0.0
    for i, forward in enumerate((False, True)):
        x = bond_inputs_c(950 + i, 1, **SHAPE)
        kw = dict(forward=forward, power_iters=3)
        got = bkc.qr_bond_step_c(*k12_args(x, forward), plain=False, **kw)
        torch.cuda.synchronize()
        ref = bkc.qr_bond_step_c(*k12_args(x, forward), plain=True, **kw)
        cqr_err = max(cqr_err, compare(f"complex QR bond {kw}", got, ref,
                                       forward))
    print(f"[kernel-vs-plain] K1c 8 cases, max |err| {cerr['k1c']:.3e}; K2c "
          f"4 cases, max |err| {cerr['k2c']:.3e}; complex QR bond (K1c -> "
          f"realified QR -> K2c, q 3) 2 cases, max |err| {cqr_err:.3e} "
          f"(rtol {RTOL}, atol {ATOL}); kept ranks equal", flush=True)
    err.update(cerr)

    # timed calls: the complex path's bond (backward refresh, q 3), a frozen
    # block of 4 (the qr fit's frozen sweeps), one qr refresh bond's halves
    xc1 = bond_inputs_c(17, 1, **SHAPE)
    xc4 = bond_inputs_c(18, 4, **SHAPE)
    kw3 = dict(forward=False, refresh=True, power_iters=3)
    kwf = dict(forward=False, refresh=False, power_iters=1)
    times["k12c"] = (
        time_ms(lambda: bkc.k12c_cuda(*k12_args(xc1, False), **kw3)),
        time_ms(lambda: bkc.k12c_plain(*k12_args(xc1, False), **kw3)))
    times["k12mc"] = (
        time_ms(lambda: bkc.k12mc_cuda(*k12m_args(xc4), **kwf)),
        time_ms(lambda: bkc.k12mc_plain(*k12m_args(xc4), **kwf)))
    a1c = k1c_args(xc1, False)
    BTc, Yc = bkc.k1c_cuda(*a1c, forward=False, power_iters=3)
    Qc = _qr_orth(Yc).contiguous()
    a2c = (BTc, Qc, xc1["envx"][0], xc1["ls0"], xc1["phir"][0], 1e-10)
    times["k1c"] = (
        time_ms(lambda: bkc.k1c_cuda(*a1c, forward=False, power_iters=3)),
        time_ms(lambda: bkc.k1c_plain(*a1c, forward=False, power_iters=3)))
    times["k2c"] = (time_ms(lambda: bkc.k2c_cuda(*a2c, forward=False)),
                    time_ms(lambda: bkc.k2c_plain(*a2c, forward=False)))
    cqr_ms = time_ms(lambda: _qr_orth(Yc))
    print(f"[timing] complex: K12c (refresh, q 3) {times['k12c'][0]:.3f} ms "
          f"vs plain {times['k12c'][1]:.3f} ms; K12mc (frozen, Bb 4) "
          f"{times['k12mc'][0]:.3f} ms vs plain {times['k12mc'][1]:.3f} ms; "
          f"K1c (qr, q 3) {times['k1c'][0]:.3f} ms vs plain "
          f"{times['k1c'][1]:.3f} ms; realified QR of Y {list(Yc.shape)} "
          f"{cqr_ms:.3f} ms; K2c {times['k2c'][0]:.3f} ms vs plain "
          f"{times['k2c'][1]:.3f} ms ({card})", flush=True)

    # ---- 8. complex path --------------------------------------------------
    fourier = dict(encoding="fourier", verbosity=-1, log_level=-1)
    bk.reset_counts()
    c_trained, c_info, _ = mt.fit_mps(Xtr, ytr, Xte, yte,
                                      mt.MPSOptions(**fourier),
                                      device="cuda")
    torch.cuda.synchronize()
    c_launches, c_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    t0 = time.perf_counter()
    c_preds = mt.classify(c_trained, Xte)
    torch.cuda.synchronize()
    c_classify_s = time.perf_counter() - t0
    c_acc = float(np.mean(c_preds == yte))
    m = c_trained.mps
    check(m.cores.is_cuda and m.cores.dtype == torch.complex64,
          f"fourier fit: model {m.cores.dtype} on {m.cores.device}")
    check(tuple(m.center.shape) == (25, 5, 25, 2), f"center {m.center.shape}")
    for t in (m.cores, m.center):
        check(bool(torch.isfinite(t).all()), "fourier fit: non-finite weights")
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k12c": 10 * 190}
    check(c_launches == want, f"fourier fit: launches {c_launches} != {want}")
    check(sum(c_plain.values()) == 0, f"fourier fit: plain calls {c_plain}")
    check(FOURIER_ACC[0] <= c_acc <= FOURIER_ACC[1],
          f"fourier fit: test accuracy {c_acc} outside {FOURIER_ACC}")
    c_sweep_s = statistics.median(c_info["sweep_seconds"][1:])
    print(f"[complex-path] ECG200 MPSOptions(encoding='fourier') (complex64, "
          f"d 5, chi 25, q 3, 10 sweeps) on cuda: test accuracy {c_acc:.4f}; "
          f"median sweep {c_sweep_s:.4f} s (after 1 warm sweep); classify "
          f"{c_classify_s:.4f} s for {len(Xte)} series; launches "
          f"{ {k: v for k, v in c_launches.items() if v} }; plain calls "
          f"{sum(c_plain.values())} ({card})", flush=True)

    # the fourier fit's accuracy over other init seeds (reported, not held)
    c_seed_acc = {}
    for seed in (1, 2):
        tr, inf, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
            **fourier, init_rng=seed), device="cuda")
        c_seed_acc[seed] = (float(np.mean(mt.classify(tr, Xte) == yte)),
                            statistics.median(inf["sweep_seconds"][1:]))
    print("[complex-seeds] ECG200 MPSOptions(encoding='fourier') on cuda, "
          "init_rng: test accuracy, median sweep s: " + "; ".join(
              f"{s}: {a:.4f}, {t:.4f}" for s, (a, t) in c_seed_acc.items())
          + f" ({card})", flush=True)

    bk.reset_counts()
    cq_trained, cq_info, _ = mt.fit_mps(
        Xtr, ytr, opts=mt.MPSOptions(**fourier, orth_alg="qr",
                                     subspace_refresh_every=2),
        device="cuda")
    cq_preds = mt.classify(cq_trained, Xte)
    torch.cuda.synchronize()
    cq_launches, cq_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    for t in (cq_trained.mps.cores, cq_trained.mps.center):
        check(bool(torch.isfinite(t).all()), "complex qr fit: non-finite")
    # 95 bonds per half-sweep: 23 blocks of 4 and one of 3 when frozen
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k1c": 5 * 190, "k2c": 5 * 190,
            "k12mc": 5 * 48}
    check(cq_launches == want, f"complex qr fit: launches {cq_launches} != "
          f"{want}")
    check(sum(cq_plain.values()) == 0, f"complex qr fit: plain calls "
          f"{cq_plain}")
    secs = cq_info["sweep_seconds"]
    print(f"[complex-qr-path] ECG200 MPSOptions(encoding='fourier', "
          f"orth_alg='qr', subspace_refresh_every=2) on cuda: test accuracy "
          f"{float(np.mean(cq_preds == yte)):.4f} (reported, no floor); "
          f"median refresh sweep {statistics.median(secs[2::2]):.4f} s, "
          f"frozen sweep {statistics.median(secs[1::2]):.4f} s; launches "
          f"{ {k: v for k, v in cq_launches.items() if v} }; plain calls "
          f"{sum(cq_plain.values())} ({card})", flush=True)

    # where a complex sweep's device time goes: the default fourier fit's
    # first sweep and a qr refresh + frozen sweep, under torch.profiler
    for label, kw in (("fourier fit, one sweep", dict(nsweeps=1)),
                      ("fourier qr fit, one refresh + one frozen sweep",
                       dict(nsweeps=2, orth_alg="qr",
                            subspace_refresh_every=2))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, p_info, _ = mt.fit_mps(Xtr, ytr,
                                      opts=mt.MPSOptions(**fourier, **kw),
                                      device="cuda")
            torch.cuda.synchronize()
        dev = device_ms(prof)
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
        # a fit launches K1c, K2c and K12mc over a cluster only, never
        # their one-block kernels
        check(not any(n in k for k in dev
                      for n in ("k1_kernel", "k2_kernel", "k12m_kernel")),
              f"{label}: a one-block K1c, K2c or K12mc ran: {list(dev)}")
        k1c_ms = sum(v for k, v in dev.items() if "k1_cluster_kernel" in k)
        k2c_ms = sum(v for k, v in dev.items() if "k2_cluster_kernel" in k)
        k12mc_ms = sum(v for k, v in dev.items()
                       if "k12m_cluster_kernel" in k)
        print(f"[profile] {label} on cuda: device busy "
              f"{sum(dev.values()):.1f} ms of "
              f"{1e3 * sum(p_info['sweep_seconds']):.1f} ms sweep wall time; "
              f"K1c (cluster) {k1c_ms:.1f} ms, K2c (cluster) {k2c_ms:.1f} "
              f"ms, K12mc (cluster) {k12mc_ms:.1f} ms; by kernel: "
              + "; ".join(
                  f"{k[:60]} {v:.1f} ms" for k, v in top)
              + f" ({card})", flush=True)

    # ---- 9. ritz kernel ---------------------------------------------------
    ritz_grid = [(f, r, q, n, mr) for f in (False, True)
                 for r, q, n, mr in ((True, 1, 6, None), (False, 1, 6, None),
                                     (True, 3, 24, None), (True, 1, 6, 17))]
    rerr = inv_err = 0.0
    for shape, seed0 in ((RITZ_SHAPE, 1000), (dict(C=2, chi=8, d=3, N=16),
                                              1100)):
        for i, (forward, refresh, q, rounds, mr) in enumerate(ritz_grid):
            x = bond_inputs_c(seed0 + i, 1, **shape)
            kw = dict(forward=forward, refresh=refresh, power_iters=q,
                      rounds=rounds, max_rank=mr)
            name = f"K12cr {shape} {kw}"
            got = bkc.k12cr_cuda(*k12_args(x, forward), **kw)
            torch.cuda.synchronize()
            ref = bkc.k12cr_plain(*k12_args(x, forward), **kw)
            rerr = max(rerr, compare(name, got, ref, forward, atol=RITZ_ATOL,
                                     rtol=RITZ_RTOL))
            inv_err = max(inv_err, compare_all(
                name + " gauge invariants", ritz_invariants(got, forward),
                ritz_invariants(ref, forward)))
    err["k12cr"] = rerr
    print(f"[kernel-vs-plain] K12cr {2 * len(ritz_grid)} cases (C 2, chi 64, "
          f"d 5, N 100 and C 2, chi 8, d 3, N 16): raw outputs max |err| "
          f"{rerr:.3e} (rtol {RITZ_RTOL}, atol {RITZ_ATOL}); gauge invariants "
          f"max |err| {inv_err:.3e} (rtol {RTOL}, atol {ATOL}); kept ranks "
          "equal", flush=True)
    xr = bond_inputs_c(19, 1, **RITZ_SHAPE)
    kwr = dict(forward=False, refresh=True, power_iters=1, rounds=6)
    times["k12cr"] = (
        time_ms(lambda: bkc.k12cr_cuda(*k12_args(xr, False), **kwr)),
        time_ms(lambda: bkc.k12cr_plain(*k12_args(xr, False), **kwr)))
    ritz_bound = bound(k12cr_work(**RITZ_SHAPE))
    print(f"[timing] K12cr (backward refresh bond, C 2, chi 64, d 5, N 100, "
          f"q 1, 6 rounds) {times['k12cr'][0]:.3f} ms vs plain "
          f"{times['k12cr'][1]:.3f} ms; bound {ritz_bound[0]:.4f} ms "
          f"({ritz_bound[1]}) ({card})", flush=True)

    # ---- 10. ritz path ----------------------------------------------------
    # log_level 1: each sweep's train KLD (computed after its timing)
    ritz = dict(encoding="fourier", chi_max=64, nsweeps=5, verbosity=-1,
                log_level=1)
    r_opts = mt.MPSOptions(**ritz)
    resolved = (r_opts.resolved_svd_alg("cuda"), r_opts.resolved_orth_alg(
        "cuda"), r_opts.resolved_power_iters("cuda"),
        r_opts.resolved_ritz_rots("cuda"))
    check(resolved == ("randomized_warm_ritz", "qr", 1, ("eigh", "jacobi")),
          f"ritz options resolve to {resolved}")
    bk.reset_counts()
    r_trained, r_info, _ = mt.fit_mps(Xtr, ytr, Xte, yte, r_opts,
                                      device="cuda")
    torch.cuda.synchronize()
    r_launches, r_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
    t0 = time.perf_counter()
    r_preds = mt.classify(r_trained, Xte)
    torch.cuda.synchronize()
    r_classify_s = time.perf_counter() - t0
    r_acc = float(np.mean(r_preds == yte))
    r_train_acc = float(np.mean(mt.classify(r_trained, Xtr) == ytr))
    m = r_trained.mps
    check(m.cores.is_cuda and m.cores.dtype == torch.complex64,
          f"ritz fit: model {m.cores.dtype} on {m.cores.device}")
    check(tuple(m.center.shape) == (64, 5, 64, 2), f"center {m.center.shape}")
    for t in (m.cores, m.center):
        check(bool(torch.isfinite(t).all()), "ritz fit: non-finite weights")
    # sweeps 0-1 exact (unfused, no kernel), 2-4 tracked (one K12cr a bond)
    want = {**dict.fromkeys(bk.LAUNCHES, 0), "k12cr": 3 * 190}
    check(r_launches == want, f"ritz fit: launches {r_launches} != {want}")
    check(sum(r_plain.values()) == 0, f"ritz fit: plain calls {r_plain}")
    check(RITZ_ACC[0] <= r_acc <= RITZ_ACC[1],
          f"ritz fit: test accuracy {r_acc} outside {RITZ_ACC}")
    secs = r_info["sweep_seconds"]
    print(f"[ritz-path] ECG200 MPSOptions(encoding='fourier', chi_max=64, "
          f"nsweeps=5) on cuda, resolved {resolved}: test accuracy "
          f"{r_acc:.4f} (train {r_train_acc:.4f}); exact sweeps "
          f"{secs[0]:.4f}, {secs[1]:.4f} s, tracked sweeps median "
          f"{statistics.median(secs[2:]):.4f} s "
          f"({', '.join(f'{t:.4f}' for t in secs[2:])}); classify "
          f"{r_classify_s:.4f} s for {len(Xte)} series; train KLD by sweep "
          f"{[round(float(v), 3) for v in r_info['train_KL_div']]}; "
          f"launches { {k: v for k, v in r_launches.items() if v} }; plain "
          f"calls {sum(r_plain.values())} ({card})", flush=True)

    # the same fit with an exact eigh on every sweep (ritz_exact_sweeps=-1,
    # the unfused route throughout), reported beside the tracked one
    bk.reset_counts()
    e_trained, e_info, _ = mt.fit_mps(
        Xtr, ytr, Xte, yte, r_opts.replace(ritz_exact_sweeps=-1),
        device="cuda")
    check(sum(bk.LAUNCHES.values()) + sum(bk.PLAIN_CALLS.values()) == 0,
          f"exact ritz fit: launches {bk.LAUNCHES}, plain {bk.PLAIN_CALLS}")
    print(f"[ritz-exact] the same fit with ritz_exact_sweeps=-1 on cuda: test "
          f"accuracy {float(np.mean(mt.classify(e_trained, Xte) == yte)):.4f}"
          f" (train {float(np.mean(mt.classify(e_trained, Xtr) == ytr)):.4f});"
          f" sweeps {[round(t, 4) for t in e_info['sweep_seconds']]} s; "
          f"train KLD by sweep "
          f"{[round(float(v), 3) for v in e_info['train_KL_div']]} ({card})",
          flush=True)

    # the ritz fit's accuracy over other init seeds (reported, not held)
    r_seed_acc = {}
    for seed in (1, 2):
        tr, inf, _ = mt.fit_mps(Xtr, ytr, opts=r_opts.replace(init_rng=seed),
                                device="cuda")
        r_seed_acc[seed] = (float(np.mean(mt.classify(tr, Xte) == yte)),
                            float(np.mean(mt.classify(tr, Xtr) == ytr)))
    print("[ritz-seeds] ECG200 MPSOptions(encoding='fourier', chi_max=64, "
          "nsweeps=5) on cuda, init_rng: test accuracy, train accuracy: "
          + "; ".join(f"{s}: {a:.4f}, {b:.4f}"
                      for s, (a, b) in r_seed_acc.items())
          + f" ({card})", flush=True)

    # where a tracked sweep's device time goes: one sweep tracked from the
    # start (ritz_exact_sweeps=0), 190 K12cr launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, p_info, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
            **{**ritz, "nsweeps": 1, "log_level": -1}, ritz_exact_sweeps=0),
            device="cuda")
        torch.cuda.synchronize()
    dev = device_ms(prof)
    busy = sum(dev.values())
    wall = 1e3 * sum(p_info["sweep_seconds"])
    k12cr_ms = sum(v for k, v in dev.items() if "k12cr" in k)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:3]
    print(f"[ritz-profile] one tracked sweep (ritz_exact_sweeps=0) on cuda: "
          f"device busy {busy:.1f} ms of {wall:.1f} ms sweep wall time "
          f"({100 * busy / wall:.1f} %); K12cr {k12cr_ms:.1f} ms "
          f"({100 * k12cr_ms / max(busy, 1e-9):.1f} % of device time); by "
          "kernel: " + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top)
          + f" ({card})", flush=True)

    # ---- 11. dp kernels ---------------------------------------------------
    from mpstime_tpu_torch.parallel import Mesh, make_mesh
    one = make_mesh(1)
    derr = dict.fromkeys(("k1a", "k1b", "k2_split", "k2_env"), 0.0)
    for i, (forward, loss) in enumerate((f, l) for f in (False, True)
                                        for l in ("KLD", "MSE")):
        a = dp_args(1200 + i, forward)[:9]
        got = bk.k1a_cuda(*a, forward=forward, loss=loss)
        torch.cuda.synchronize()
        derr["k1a"] = max(derr["k1a"], compare_all(
            f"K1a {forward} {loss}", [got],
            [bk.k1a_plain(*a, forward=forward, loss=loss)]))
    k1b_grid = [(f, e, q, o, b) for f in (False, True)
                for e, q, o, b in ((True, 1, "ns", "TSGO"),
                                   (True, 3, "ns", "TSGO"),
                                   (True, 1, "qr", "TSGO"),
                                   (True, 3, "qr", "GD"),
                                   (False, 1, "qr", "TSGO"))]
    for i, (forward, emit_y, q, orth, bbopt) in enumerate(k1b_grid):
        a = dp_args(1300 + i, forward)
        G = bk.k1a_plain(*a[:9], forward=forward)
        kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth,
                  bbopt=bbopt)
        got = bk.k1b_cuda(a[0], a[1], G, a[9], 0.05, **kw)
        torch.cuda.synchronize()
        derr["k1b"] = max(derr["k1b"], compare_all(
            f"K1b {kw}", got, bk.k1b_plain(a[0], a[1], G, a[9], 0.05, **kw)))
    for i, (forward, mr) in enumerate((f, m) for f in (False, True)
                                      for m in (None, 17)):
        a = dp_args(1400 + i, forward)
        BT, Y = bk.k1_plain(*a[:10], 0.05, forward=forward)
        Q = torch.linalg.qr(Y).Q.contiguous()
        got = bk.k2_split_cuda(BT, Q, 1e-10, forward=forward, max_rank=mr)
        torch.cuda.synchronize()
        ref = bk.k2_split_plain(BT, Q, 1e-10, forward=forward, max_rank=mr)
        derr["k2_split"] = max(derr["k2_split"], compare_all(
            f"K2-split {forward} max_rank={mr}", got, ref))
        check(bool(torch.equal(got[2] != 0, ref[2] != 0)),
              f"K2-split {forward} max_rank={mr}: kept ranks differ")
        env, ls, phi = a[10:]
        got = bk.k2_env_cuda(ref[2], env, ls, phi, forward=forward)
        torch.cuda.synchronize()
        derr["k2_env"] = max(derr["k2_env"], compare_all(
            f"K2-env {forward} max_rank={mr}", got,
            bk.k2_env_plain(ref[2], env, ls, phi, forward=forward)))
    print(f"[kernel-vs-plain] K1a 4 cases, max |err| {derr['k1a']:.3e}; K1b "
          f"{len(k1b_grid)} cases, max |err| {derr['k1b']:.3e}; K2-split 4 "
          f"cases, max |err| {derr['k2_split']:.3e}; K2-env 4 cases, max "
          f"|err| {derr['k2_env']:.3e} (rtol {RTOL}, atol {ATOL}); kept ranks "
          "equal", flush=True)
    err.update(derr)
    # the chain on one shard is K12's and K1 -> QR -> K2's arithmetic; two
    # shards of the card sum the gradient in another order
    chain_err = two_err = 0.0
    for i, forward in enumerate((False, True)):
        x = bond_inputs(1500 + i, 1, **SHAPE)
        args = k12_args(x, forward)
        chain_err = max(chain_err, compare(
            f"dp chain (ns) {forward} vs K12",
            dp_step(bk.bond_step_dp, one, args, forward, orth="ns"),
            bk.k12_cuda(*args, forward=forward), forward, atol=CHAIN_ATOL,
            rtol=0.0))
        chain_err = max(chain_err, compare(
            f"dp chain (qr) {forward} vs K1 -> QR -> K2",
            dp_step(bk.bond_step_dp, one, args, forward, orth="qr"),
            bk.qr_bond_step(*args, forward=forward, plain=False), forward,
            atol=CHAIN_ATOL, rtol=0.0))
        two_err = max(two_err, compare(
            f"dp bond on two shards {forward}",
            dp_step(bk.bond_step_dp, Mesh(["cuda:0"] * 2), args, forward,
                    orth="ns"),
            dp_step(bk.bond_step_dp, one, args, forward, orth="ns"), forward,
            atol=DP2_BOND_ATOL, rtol=0.0))
    stream_err = 0.0
    for i, (forward, orth) in enumerate((f, o) for f in (False, True)
                                        for o in ("ns", "qr")):
        x = bond_inputs(1600 + i, 1, **SHAPE)
        n0 = bk.LAUNCHES["k1a"]
        got = bk.bond_step(*k12_args(x, forward), forward=forward, orth=orth,
                           stream_tile=32)
        check(bk.LAUNCHES["k1a"] == n0 + 4, "stream: 4 tiles of 100 rows")
        stream_err = max(stream_err, compare(
            f"stream {forward} {orth}", got,
            bk.bond_step(*k12_args(x, forward), forward=forward, orth=orth),
            forward, atol=STREAM_ATOL, rtol=STREAM_RTOL))
    print(f"[kernel-vs-plain] K1a -> K1b -> K2-split -> K2-env on one shard "
          f"vs K12 and vs K1 -> QR -> K2, 4 cases, max |err| {chain_err:.3e} "
          f"(atol {CHAIN_ATOL}); one bond on two shards of the card vs one "
          f"shard, 2 cases, max |err| {two_err:.3e} (atol {DP2_BOND_ATOL}); "
          "kept ranks equal", flush=True)
    print(f"[stream] bond_step(stream_tile=32) at N=100 (4 tiles) vs the "
          f"unstreamed bond step, ns and qr, both directions: max |err| "
          f"{stream_err:.3e} (rtol {STREAM_RTOL}, atol {STREAM_ATOL}); kept "
          "ranks equal", flush=True)
    xd = dp_args(21, False)
    G1 = bk.k1a_cuda(*xd[:9], forward=False)
    BTd, Yd = bk.k1b_cuda(xd[0], xd[1], G1, xd[9], 0.05, forward=False,
                          orth="ns")
    _, _, Qm1 = bk.k2_split_cuda(BTd, Yd, 1e-10, forward=False)
    env1, ls1, phi1 = xd[10:]
    times["k1a"] = (time_ms(lambda: bk.k1a_cuda(*xd[:9], forward=False)),
                    time_ms(lambda: bk.k1a_plain(*xd[:9], forward=False)))
    kwb = dict(forward=False, orth="ns")
    times["k1b"] = (
        time_ms(lambda: bk.k1b_cuda(xd[0], xd[1], G1, xd[9], 0.05, **kwb)),
        time_ms(lambda: bk.k1b_plain(xd[0], xd[1], G1, xd[9], 0.05, **kwb)))
    times["k2_split"] = (
        time_ms(lambda: bk.k2_split_cuda(BTd, Yd, 1e-10, forward=False)),
        time_ms(lambda: bk.k2_split_plain(BTd, Yd, 1e-10, forward=False)))
    times["k2_env"] = (
        time_ms(lambda: bk.k2_env_cuda(Qm1, env1, ls1, phi1, forward=False)),
        time_ms(lambda: bk.k2_env_plain(Qm1, env1, ls1, phi1,
                                        forward=False)))
    print("[timing] dp pieces of one backward refresh bond (KLD, TSGO, ns, q "
          "1, N 100): " + "; ".join(
              f"{k} {times[k][0]:.3f} ms vs plain {times[k][1]:.3f} ms"
              for k in ("k1a", "k1b", "k2_split", "k2_env"))
          + f" ({card})", flush=True)

    # ---- 12. dp path -------------------------------------------------------
    # the single-device fused fit's first sweep, for the dp fit to meet
    _, f_info, _ = mt.fit_mps(Xtr, ytr, Xte, yte, mt.MPSOptions(
        verbosity=-1, log_level=1, nsweeps=1), device="cuda")
    fused_kld = float(f_info["train_KL_div"][1])
    dp_runs, dp_counts = {}, {}
    for label, mesh in (("dp-path", make_mesh(1)),
                        ("dp2-path", Mesh(["cuda:0"] * 2))):
        n = len(mesh)
        bk.reset_counts()
        d_trained, d_info, _ = mt.fit_mps(
            Xtr, ytr, Xte, yte, mt.MPSOptions(verbosity=-1, log_level=1),
            mesh=mesh)
        d_launches, d_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_preds = mt.classify(d_trained, Xte)
        torch.cuda.synchronize()
        d_classify_s = time.perf_counter() - t0
        d_acc = float(np.mean(d_preds == yte))
        m = d_trained.mps
        check(m.center.device == torch.device("cuda", 0),
              f"{label}: model on {m.center.device}")
        for t in (m.cores, m.center):
            check(bool(torch.isfinite(t).all()),
                  f"{label}: non-finite weights")
        want = {**dict.fromkeys(bk.LAUNCHES, 0), "k1a": 1900 * n,
                "k1b": 1900, "k2_split": 1900, "k2_env": 1900 * n}
        check(d_launches == want, f"{label}: launches {d_launches} != {want}")
        check(sum(d_plain.values()) == 0, f"{label}: plain calls {d_plain}")
        check(mesh.reductions == 1900, f"{label}: {mesh.reductions} "
              "reductions, not one a bond")
        check(d_acc >= QR_ACC_FLOOR, f"{label}: test accuracy {d_acc} < "
              f"{QR_ACC_FLOOR}")
        kld = [float(v) for v in d_info["train_KL_div"]]
        dp_runs[label], dp_counts[label] = kld, d_launches
        line = (f"[{label}] ECG200 default MPSOptions on {mesh}: test "
                f"accuracy {d_acc:.4f} (train "
                f"{float(d_info['train_acc'][-1]):.4f}); median sweep "
                f"{statistics.median(d_info['sweep_seconds'][1:]):.4f} s "
                f"(after 1 warm sweep); classify {d_classify_s:.4f} s for "
                f"{len(Xte)} series; train KLD by sweep "
                f"{[round(v, 4) for v in kld]}; launches "
                f"{ {k: v for k, v in d_launches.items() if v} }; plain calls "
                f"{sum(d_plain.values())}; reductions {mesh.reductions}")
        if n == 1:
            rel = abs(kld[1] - fused_kld) / abs(fused_kld)
            check(rel <= DP_KLD_RTOL, f"dp-path: sweep-1 train KLD {kld[1]} "
                  f"vs the fused fit's {fused_kld}: {rel:.3e} relative")
            line += (f"; sweep-1 train KLD {kld[1]:.6f} vs the fused fit's "
                     f"{fused_kld:.6f} ({rel:.2e} relative, held to "
                     f"{DP_KLD_RTOL})")
        else:
            one_kld = dp_runs["dp-path"]
            rel1 = abs(kld[1] - one_kld[1]) / abs(one_kld[1])
            rel = abs(kld[-1] - one_kld[-1]) / abs(one_kld[-1])
            check(rel <= DP2_FINAL_KLD_RTOL, f"dp2-path: final train KLD "
                  f"{kld[-1]} vs dp-path's {one_kld[-1]}: {rel:.3e} relative")
            line += (f"; vs dp-path: sweep-1 train KLD {rel1:.2e} relative "
                     f"(reported), final {rel:.2e} (held to "
                     f"{DP2_FINAL_KLD_RTOL})")
        print(line + f" ({card})", flush=True)
    dp_launches = dp_counts["dp-path"]
    # where a dp sweep's device time goes: one sweep on one and two shards
    for label, mesh in (("one shard", make_mesh(1)),
                        ("two shards of the card", Mesh(["cuda:0"] * 2))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, p_info, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
                verbosity=-1, log_level=-1, nsweeps=1), mesh=mesh)
            torch.cuda.synchronize()
        dev = device_ms(prof)
        busy = sum(dev.values())
        wall = 1e3 * sum(p_info["sweep_seconds"])
        # K1a, K1b and K2-split run over a cluster and K2-env over row
        # tiles, never on one block
        check(not any(k in n for n in dev for k in (
            "k1a_kernel", "k1b_kernel", "k2_split_kernel", "k2_env_kernel")),
              f"dp-profile: a one-block K1a, K1b, K2-split or K2-env ran: "
              f"{list(dev)}")
        parts = {k: sum(v for n, v in dev.items() if kern in n)
                 for k, kern in (("k1a", "k1a_cluster_kernel"),
                                 ("k1b", "k1b_cluster_kernel"),
                                 ("k2_split", "k2_split_cluster_kernel"),
                                 ("k2_env", "k2_env_rows_kernel"))}
        copies = {n: v for n, v in dev.items() if "emcpy" in n}
        print(f"[dp-profile] one sweep on {label} (default options): device "
              f"busy {busy:.1f} ms of {wall:.1f} ms sweep wall time "
              f"({100 * busy / wall:.1f} %); " + "; ".join(
                  f"{k} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f} %)"
                  for k, v in parts.items())
              + f"; the rest {busy - sum(parts.values()):.1f} ms; copies "
              f"{ {k[:40]: round(v, 3) for k, v in copies.items()} } "
              f"({card})", flush=True)

    # ---- 13. complex dp kernels -------------------------------------------
    cderr = dict.fromkeys(("k1c_grad", "k1c_update", "k2c_split", "k2c_env"),
                          0.0)
    for i, forward in enumerate((False, True)):
        a = dp_args(1700 + i, forward, cplx=True)[:9]
        got = bkc.k1c_grad_cuda(*a, forward=forward)
        torch.cuda.synchronize()
        cderr["k1c_grad"] = max(cderr["k1c_grad"], compare_all(
            f"K1c-grad {forward}", [got],
            [bkc.k1c_grad_plain(*a, forward=forward)]))
    k1cu_grid = [(f, e, q, o) for f in (False, True)
                 for e, q, o in ((True, 1, "ns"), (True, 3, "ns"),
                                 (True, 1, "qr"), (True, 3, "qr"),
                                 (False, 1, "qr"))]
    for i, (forward, emit_y, q, orth) in enumerate(k1cu_grid):
        a = dp_args(1800 + i, forward, cplx=True)
        G = bkc.k1c_grad_plain(*a[:9], forward=forward)
        kw = dict(forward=forward, emit_y=emit_y, power_iters=q, orth=orth)
        got = bkc.k1c_update_cuda(a[0], a[1], G, a[9], 0.05, **kw)
        torch.cuda.synchronize()
        cderr["k1c_update"] = max(cderr["k1c_update"], compare_all(
            f"K1c-update {kw}", got,
            bkc.k1c_update_plain(a[0], a[1], G, a[9], 0.05, **kw)))
    for i, (forward, mr) in enumerate((f, m) for f in (False, True)
                                      for m in (None, 17)):
        a = dp_args(1900 + i, forward, cplx=True)
        BT, Y = bkc.k1c_plain(*a[:8], a[9], 0.05, forward=forward,
                              power_iters=3)
        Q = _qr_orth(Y).contiguous()
        got = bkc.k2c_split_cuda(BT, Q, 1e-10, forward=forward, max_rank=mr)
        torch.cuda.synchronize()
        ref = bkc.k2c_split_plain(BT, Q, 1e-10, forward=forward, max_rank=mr)
        cderr["k2c_split"] = max(cderr["k2c_split"], compare_all(
            f"K2c-split {forward} max_rank={mr}", got, ref))
        check(bool(torch.equal(got[2] != 0, ref[2] != 0)),
              f"K2c-split {forward} max_rank={mr}: kept ranks differ")
        env, ls, phi = a[10:]
        got = bkc.k2c_env_cuda(ref[2], env, ls, phi, forward=forward)
        torch.cuda.synchronize()
        cderr["k2c_env"] = max(cderr["k2c_env"], compare_all(
            f"K2c-env {forward} max_rank={mr}", got,
            bkc.k2c_env_plain(ref[2], env, ls, phi, forward=forward)))
    print(f"[kernel-vs-plain] K1c-grad 2 cases, max |err| "
          f"{cderr['k1c_grad']:.3e}; K1c-update {len(k1cu_grid)} cases, max "
          f"|err| {cderr['k1c_update']:.3e}; K2c-split 4 cases, max |err| "
          f"{cderr['k2c_split']:.3e}; K2c-env 4 cases, max |err| "
          f"{cderr['k2c_env']:.3e} (rtol {RTOL}, atol {ATOL}); kept ranks "
          "equal", flush=True)
    err.update(cderr)
    # the chain on one shard is K12c's and K1c -> QR -> K2c's arithmetic
    cchain_err = ctwo_err = 0.0
    for i, forward in enumerate((False, True)):
        x = bond_inputs_c(2000 + i, 1, **SHAPE)
        args = k12_args(x, forward)
        kw = dict(power_iters=3)
        cchain_err = max(cchain_err, compare(
            f"complex dp chain (ns) {forward} vs K12c",
            dp_step(bkc.bond_step_c_dp, one, args, forward, orth="ns", **kw),
            bkc.k12c_cuda(*args, forward=forward, **kw), forward,
            atol=CHAIN_ATOL, rtol=0.0))
        cchain_err = max(cchain_err, compare(
            f"complex dp chain (qr) {forward} vs K1c -> QR -> K2c",
            dp_step(bkc.bond_step_c_dp, one, args, forward, orth="qr", **kw),
            bkc.qr_bond_step_c(*args, forward=forward, plain=False, **kw),
            forward, atol=CHAIN_ATOL, rtol=0.0))
        ctwo_err = max(ctwo_err, compare(
            f"complex dp bond on two shards {forward}",
            dp_step(bkc.bond_step_c_dp, Mesh(["cuda:0"] * 2), args, forward,
                    orth="ns", **kw),
            dp_step(bkc.bond_step_c_dp, one, args, forward, orth="ns", **kw),
            forward, atol=DP2_BOND_ATOL, rtol=0.0))
    cstream_err = 0.0
    for i, (forward, orth) in enumerate((f, o) for f in (False, True)
                                        for o in ("ns", "qr")):
        x = bond_inputs_c(2100 + i, 1, **SHAPE)
        kw = dict(forward=forward, orth=orth, power_iters=3)
        n0 = bk.LAUNCHES["k1c_grad"]
        got = bkc.bond_step_c(*k12_args(x, forward), stream_tile=32, **kw)
        check(bk.LAUNCHES["k1c_grad"] == n0 + 4,
              "complex stream: 4 tiles of 100 rows")
        cstream_err = max(cstream_err, compare(
            f"complex stream {forward} {orth}", got,
            bkc.bond_step_c(*k12_args(x, forward), **kw), forward,
            atol=STREAM_ATOL, rtol=STREAM_RTOL))
    print(f"[kernel-vs-plain] K1c-grad -> K1c-update -> K2c-split -> K2c-env "
          f"on one shard (q 3) vs K12c and vs K1c -> realified QR -> K2c, 4 "
          f"cases, max |err| {cchain_err:.3e} (atol {CHAIN_ATOL}); one bond "
          f"on two shards of the card vs one shard, 2 cases, max |err| "
          f"{ctwo_err:.3e} (atol {DP2_BOND_ATOL}); kept ranks equal",
          flush=True)
    print(f"[complex-stream] bond_step_c(stream_tile=32) at N=100 (4 tiles, "
          f"q 3) vs the unstreamed complex bond step, ns and qr, both "
          f"directions: max |err| {cstream_err:.3e} (rtol {STREAM_RTOL}, "
          f"atol {STREAM_ATOL}); kept ranks equal", flush=True)
    xdc = dp_args(22, False, cplx=True)
    G1c = bkc.k1c_grad_cuda(*xdc[:9], forward=False)
    kwc = dict(forward=False, orth="ns", power_iters=3)
    BTdc, Ydc = bkc.k1c_update_cuda(xdc[0], xdc[1], G1c, xdc[9], 0.05, **kwc)
    _, _, Qm1c = bkc.k2c_split_cuda(BTdc, Ydc, 1e-10, forward=False)
    env1c, ls1c, phi1c = xdc[10:]
    times["k1c_grad"] = (
        time_ms(lambda: bkc.k1c_grad_cuda(*xdc[:9], forward=False)),
        time_ms(lambda: bkc.k1c_grad_plain(*xdc[:9], forward=False)))
    times["k1c_update"] = (
        time_ms(lambda: bkc.k1c_update_cuda(xdc[0], xdc[1], G1c, xdc[9],
                                            0.05, **kwc)),
        time_ms(lambda: bkc.k1c_update_plain(xdc[0], xdc[1], G1c, xdc[9],
                                             0.05, **kwc)))
    times["k2c_split"] = (
        time_ms(lambda: bkc.k2c_split_cuda(BTdc, Ydc, 1e-10, forward=False)),
        time_ms(lambda: bkc.k2c_split_plain(BTdc, Ydc, 1e-10,
                                            forward=False)))
    times["k2c_env"] = (
        time_ms(lambda: bkc.k2c_env_cuda(Qm1c, env1c, ls1c, phi1c,
                                         forward=False)),
        time_ms(lambda: bkc.k2c_env_plain(Qm1c, env1c, ls1c, phi1c,
                                          forward=False)))
    print("[timing] complex dp pieces of one backward refresh bond (KLD, "
          "TSGO, ns, q 3, N 100): " + "; ".join(
              f"{k} {times[k][0]:.3f} ms vs plain {times[k][1]:.3f} ms"
              for k in ("k1c_grad", "k1c_update", "k2c_split", "k2c_env"))
          + f" ({card})", flush=True)

    # ---- 14. complex dp path -----------------------------------------------
    # the single-device fused fourier fit's first sweep (K12c), for the dp
    # fit to meet
    _, cf_info, _ = mt.fit_mps(Xtr, ytr, Xte, yte, mt.MPSOptions(
        **{**fourier, "log_level": 1}, nsweeps=1), device="cuda")
    cfused_kld = float(cf_info["train_KL_div"][1])
    cdp_runs, cdp_counts = {}, {}
    for label, mesh in (("complex-dp-path", make_mesh(1)),
                        ("complex-dp2-path", Mesh(["cuda:0"] * 2))):
        n = len(mesh)
        bk.reset_counts()
        d_trained, d_info, _ = mt.fit_mps(
            Xtr, ytr, Xte, yte, mt.MPSOptions(**{**fourier, "log_level": 1}),
            mesh=mesh)
        d_launches, d_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_preds = mt.classify(d_trained, Xte)
        torch.cuda.synchronize()
        d_classify_s = time.perf_counter() - t0
        d_acc = float(np.mean(d_preds == yte))
        m = d_trained.mps
        check(m.center.device == torch.device("cuda", 0)
              and m.center.dtype == torch.complex64,
              f"{label}: model {m.center.dtype} on {m.center.device}")
        for t in (m.cores, m.center):
            check(bool(torch.isfinite(t).all()),
                  f"{label}: non-finite weights")
        want = {**dict.fromkeys(bk.LAUNCHES, 0), "k1c_grad": 1900 * n,
                "k1c_update": 1900, "k2c_split": 1900, "k2c_env": 1900 * n}
        check(d_launches == want, f"{label}: launches {d_launches} != {want}")
        check(sum(d_plain.values()) == 0, f"{label}: plain calls {d_plain}")
        check(mesh.reductions == 1900, f"{label}: {mesh.reductions} "
              "reductions, not one a bond")
        check(FOURIER_ACC[0] <= d_acc <= FOURIER_ACC[1],
              f"{label}: test accuracy {d_acc} outside {FOURIER_ACC}")
        kld = [float(v) for v in d_info["train_KL_div"]]
        cdp_runs[label], cdp_counts[label] = kld, d_launches
        line = (f"[{label}] ECG200 MPSOptions(encoding='fourier') (complex64, "
                f"chi 25, q 3, 10 sweeps) on {mesh}: test accuracy "
                f"{d_acc:.4f} (train {float(d_info['train_acc'][-1]):.4f}); "
                f"median sweep "
                f"{statistics.median(d_info['sweep_seconds'][1:]):.4f} s "
                f"(after 1 warm sweep); classify {d_classify_s:.4f} s for "
                f"{len(Xte)} series; train KLD by sweep "
                f"{[round(v, 4) for v in kld]}; launches "
                f"{ {k: v for k, v in d_launches.items() if v} }; plain calls "
                f"{sum(d_plain.values())}; reductions {mesh.reductions}")
        if n == 1:
            rel = abs(kld[1] - cfused_kld) / abs(cfused_kld)
            check(rel <= DP_KLD_RTOL, f"{label}: sweep-1 train KLD {kld[1]} "
                  f"vs the fused fit's {cfused_kld}: {rel:.3e} relative")
            line += (f"; sweep-1 train KLD {kld[1]:.6f} vs the fused fourier "
                     f"fit's {cfused_kld:.6f} ({rel:.2e} relative, held to "
                     f"{DP_KLD_RTOL})")
        else:
            one_kld = cdp_runs["complex-dp-path"]
            rel1 = abs(kld[1] - one_kld[1]) / abs(one_kld[1])
            rel = abs(kld[-1] - one_kld[-1]) / abs(one_kld[-1])
            check(rel <= CDP2_FINAL_KLD_RTOL, f"{label}: final train KLD "
                  f"{kld[-1]} vs complex-dp-path's {one_kld[-1]}: {rel:.3e} "
                  "relative")
            line += (f"; vs complex-dp-path: sweep-1 train KLD {rel1:.2e} "
                     f"relative (reported), final {rel:.2e} (held to "
                     f"{CDP2_FINAL_KLD_RTOL})")
        print(line + f" ({card})", flush=True)
    cdp_launches = cdp_counts["complex-dp-path"]
    # where a complex dp sweep's device time goes: one sweep on one shard
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, p_info, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
            **fourier, nsweeps=1), mesh=make_mesh(1))
        torch.cuda.synchronize()
    dev = device_ms(prof)
    busy = sum(dev.values())
    wall = 1e3 * sum(p_info["sweep_seconds"])
    check(busy > 0, "complex-dp-profile: no device time traced")
    # K1c-grad, K1c-update and K2c-split run over a cluster and K2c-env
    # over row tiles, never on one block
    check(not any(k in n for n in dev for k in (
        "k1a_kernel", "k1b_kernel", "k2_split_kernel", "k2_env_kernel")),
          f"complex-dp-profile: a one-block K1c-grad, K1c-update, K2c-split "
          f"or K2c-env ran: {list(dev)}")
    parts = {k: sum(v for n, v in dev.items() if k in n)
             for k in ("k1a_cluster_kernel", "k1b_cluster_kernel",
                       "k2_split_cluster_kernel", "k2_env_rows_kernel")}
    print(f"[complex-dp-profile] one fourier sweep on make_mesh(1): device "
          f"busy {busy:.1f} ms of {wall:.1f} ms sweep wall time "
          f"({100 * busy / wall:.1f} %); " + "; ".join(
              f"{c} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f} %)"
              for c, v in zip(("K1c-grad", "K1c-update", "K2c-split",
                               "K2c-env"), parts.values()))
          + f"; the rest {busy - sum(parts.values()):.1f} ms ({card})",
          flush=True)

    # ---- 15. split-tail kernels --------------------------------------------
    # K1-tail and K1c-tail over a stepped bond tensor (the plain K1's, as
    # the route hands it over), at the main-path shape and at chi 192
    terr = {"k1_tail": 0.0, "k1c_tail": 0.0}
    tail_grid = [(c, f, o, q) for c in (SHAPE["chi"], 192)
                 for f in (False, True) for o in ("ns", "qr") for q in (1, 3)]
    for i, (chi, forward, orth, q) in enumerate(tail_grid):
        shape = dict(SHAPE, chi=chi)
        for key, cplx in (("k1_tail", False), ("k1c_tail", True)):
            if cplx:
                x = bond_inputs_c(1700 + i, 1, **shape)
                BT, _ = bkc.k1c_plain(*k1c_args(x, forward), forward=forward,
                                      emit_y=False)
                cuda, plain = bkc.k1c_tail_cuda, bkc.k1c_tail_plain
            else:
                x = bond_inputs(1700 + i, 1, **shape)
                BT, _ = bk.k1_plain(*k1_args(x, forward), forward=forward,
                                    emit_y=False)
                cuda, plain = bk.k1_tail_cuda, bk.k1_tail_plain
            kw = dict(forward=forward, power_iters=q, orth=orth)
            got = cuda(BT, x["V0"][0], **kw)
            torch.cuda.synchronize()
            terr[key] = max(terr[key], compare_all(
                f"{key} chi={chi} {kw}", [got],
                [plain(BT, x["V0"][0], **kw)]))
    print(f"[split-tail-kernels] K1-tail {len(tail_grid)} cases (chi "
          f"{SHAPE['chi']} and 192, both directions, ns/qr, q 1/3), max |err| "
          f"{terr['k1_tail']:.3e}; K1c-tail {len(tail_grid)} cases, max |err| "
          f"{terr['k1c_tail']:.3e} (rtol {RTOL}, atol {ATOL})", flush=True)
    err.update(terr)
    # the split routes do the fused kernels' arithmetic: the same device
    # functions over the same BT with the same block size
    route_err = {}

    def held(label, got, ref, forward):
        route_err[label] = max(route_err.get(label, 0.0), compare(
            label, got, ref, forward, atol=CHAIN_ATOL, rtol=0.0))

    for i, forward in enumerate((False, True)):
        x = bond_inputs(1800 + i, 1, **SHAPE)
        args = k12_args(x, forward)
        for q in (1, 3):
            held("bond_step ns vs K12",
                 bk.bond_step(*args, forward=forward, orth="ns",
                              power_iters=q, split_tail=True),
                 bk.k12_cuda(*args, forward=forward, power_iters=q), forward)
            held("bond_step qr vs K1 -> QR -> K2",
                 bk.bond_step(*args, forward=forward, orth="qr",
                              power_iters=q, split_tail=True),
                 bk.qr_bond_step(*args, forward=forward, plain=False,
                                 power_iters=q), forward)
        for orth in ("ns", "qr"):
            held("bond_step_dp one shard",
                 dp_step(bk.bond_step_dp, one, args, forward, orth=orth,
                         split_tail=True),
                 dp_step(bk.bond_step_dp, one, args, forward, orth=orth,
                         split_tail=False), forward)
            held("stream_tile=32",
                 bk.bond_step(*args, forward=forward, orth=orth,
                              stream_tile=32, split_tail=True),
                 bk.bond_step(*args, forward=forward, orth=orth,
                              stream_tile=32, split_tail=False), forward)
        xc = bond_inputs_c(1810 + i, 1, **SHAPE)
        args = k12_args(xc, forward)
        kw = dict(forward=forward, power_iters=3)
        held("bond_step_c ns vs K12c",
             bkc.bond_step_c(*args, orth="ns", split_tail=True, **kw),
             bkc.k12c_cuda(*args, **kw), forward)
        held("bond_step_c qr vs K1c -> QR -> K2c",
             bkc.bond_step_c(*args, orth="qr", split_tail=True, **kw),
             bkc.qr_bond_step_c(*args, plain=False, **kw), forward)
        for orth in ("ns", "qr"):
            held("bond_step_c_dp one shard",
                 dp_step(bkc.bond_step_c_dp, one, args, forward, orth=orth,
                         split_tail=True, power_iters=3),
                 dp_step(bkc.bond_step_c_dp, one, args, forward, orth=orth,
                         split_tail=False, power_iters=3), forward)
            held("complex stream_tile=32",
                 bkc.bond_step_c(*args, orth=orth, stream_tile=32,
                                 split_tail=True, **kw),
                 bkc.bond_step_c(*args, orth=orth, stream_tile=32,
                                 split_tail=False, **kw), forward)
    print("[split-tail-kernels] split tail vs the fused route, both "
          "directions (real q 1 and 3, complex q 3), max |diff|: " + "; ".join(
              f"{k} {v:.3e}" for k, v in route_err.items())
          + f" (atol {CHAIN_ATOL}); kept ranks equal", flush=True)
    # fused against split, a backward refresh bond at large chi, in turns
    large = {}
    for label, chis, cplx, orth, q, rounds in (
            ("ns", (192, 256, 320), False, "ns", 1, 1),
            ("qr", (192, 256, 320), False, "qr", 1, 1),
            ("complex ns", (128, 192), True, "ns", 3, 1)):
        large[label] = {}
        for chi in chis:
            shape = dict(SHAPE, chi=chi)
            x = (bond_inputs_c if cplx else bond_inputs)(1900 + chi, 1,
                                                         **shape)
            args = k12_args(x, False)
            kw = dict(forward=False, orth=orth, power_iters=q)
            step = bkc.bond_step_c if cplx else bk.bond_step
            # split_tail=False: K12 (ns), K1 -> QR -> K2 (qr), K12c
            large[label][chi] = time_turns(
                lambda: step(*args, split_tail=False, **kw),
                lambda: step(*args, split_tail=True, **kw), rounds, iters=2)
        print(f"[split-tail-kernels] a backward refresh bond ({label}, q {q}, "
              f"C 2, d 5, N 100), per call in turns, fused vs split ms: "
              + "; ".join(
                  f"chi {chi}: {[round(t, 3) for t in tf]} vs "
                  f"{[round(t, 3) for t in ts]}"
                  for chi, (tf, ts) in large[label].items())
              + f"; the split form wins from chi "
              f"{split_wins_from(large[label])} ({card})", flush=True)
    # where the difference sits: K1's in-kernel power step (K1 with emit_y
    # less K1 without) against one K1-tail launch over the same BT
    probe = []
    for chi, cplx, q in ((192, False, 1), (320, False, 1), (192, True, 3)):
        if cplx:
            x = bond_inputs_c(1990 + chi, 1, **dict(SHAPE, chi=chi))
            k1, a1, tail = bkc.k1c_cuda, k1c_args(x, False), bkc.k1c_tail_cuda
        else:
            x = bond_inputs(1990 + chi, 1, **dict(SHAPE, chi=chi))
            k1, a1, tail = bk.k1_cuda, k1_args(x, False), bk.k1_tail_cuda
        kw = dict(forward=False, orth="ns", power_iters=q)
        BTp, _ = k1(*a1, emit_y=False, **kw)
        t_emit = time_ms(lambda: k1(*a1, **kw), 2, warmup=1)
        t_bare = time_ms(lambda: k1(*a1, emit_y=False, **kw), 2, warmup=1)
        t_tail = time_ms(lambda: tail(BTp, x["V0"][0], **kw), 2, warmup=1)
        name = "K1c" if cplx else "K1"
        probe.append(f"{name} chi {chi} q {q}: with its power steps "
                     f"{t_emit:.3f} ms, without {t_bare:.3f} ms (in-kernel "
                     f"steps {t_emit - t_bare:.3f} ms); {name}-tail at q {q} "
                     f"{t_tail:.3f} ms")
    print("[split-tail-kernels] a backward refresh bond's power steps (ns): "
          + "; ".join(probe) + f" ({card})", flush=True)
    # one rule for real and complex refresh bonds: the largest of the chis
    # from which each comparison wins, None if one never does
    wins = [split_wins_from(v) for v in large.values()]
    chi_rule = None if None in wins else max(wins)
    print(f"[split-tail-kernels] SPLIT_TAIL_CHI supported by these timings: "
          f"{chi_rule} (the package's: {bk.SPLIT_TAIL_CHI})", flush=True)
    xt = bond_inputs(23, 1, **SHAPE)
    BTt, _ = bk.k1_plain(*k1_args(xt, False), forward=False, emit_y=False)
    xtc = bond_inputs_c(24, 1, **SHAPE)
    BTtc, _ = bkc.k1c_plain(*k1c_args(xtc, False), forward=False,
                            emit_y=False)
    kwt = dict(forward=False, orth="ns")
    times["k1_tail"] = (
        time_ms(lambda: bk.k1_tail_cuda(BTt, xt["V0"][0], **kwt)),
        time_ms(lambda: bk.k1_tail_plain(BTt, xt["V0"][0], **kwt)))
    times["k1c_tail"] = (
        time_ms(lambda: bkc.k1c_tail_cuda(BTtc, xtc["V0"][0], **kwt)),
        time_ms(lambda: bkc.k1c_tail_plain(BTtc, xtc["V0"][0], **kwt)))
    print("[timing] one power step of a stored backward bond tensor (ns, q "
          "1): " + "; ".join(
              f"{k} {times[k][0]:.3f} ms vs plain {times[k][1]:.3f} ms"
              for k in ("k1_tail", "k1c_tail")) + f" ({card})", flush=True)

    # ---- 16. split-tail path ------------------------------------------------
    # the fits with every refresh bond on the split-tail route; their counts
    # are read from each run alone
    split_chi = bk.SPLIT_TAIL_CHI
    bk.SPLIT_TAIL_CHI = 0
    try:
        st_counts = {}
        for label, opts, want, ref_kld, band in (
                ("MPSOptions()", mt.MPSOptions(verbosity=-1, log_level=1),
                 {"k1": 1900, "k1_tail": 1900, "k2": 1900}, fused_kld,
                 (ACC_FLOOR, 1.0)),
                ("MPSOptions(encoding='fourier')",
                 mt.MPSOptions(**{**fourier, "log_level": 1}),
                 {"k1c": 1900, "k1c_tail": 5700, "k2c": 1900}, cfused_kld,
                 FOURIER_ACC)):
            bk.reset_counts()
            s_trained, s_info, _ = mt.fit_mps(Xtr, ytr, Xte, yte, opts,
                                              device="cuda")
            s_launches, s_plain = dict(bk.LAUNCHES), dict(bk.PLAIN_CALLS)
            s_acc = float(np.mean(mt.classify(s_trained, Xte) == yte))
            for t in (s_trained.mps.cores, s_trained.mps.center):
                check(bool(torch.isfinite(t).all()),
                      f"split-tail-path {label}: non-finite weights")
            want = {**dict.fromkeys(bk.LAUNCHES, 0), **want}
            check(s_launches == want, f"split-tail-path {label}: launches "
                  f"{s_launches} != {want}")
            check(sum(s_plain.values()) == 0,
                  f"split-tail-path {label}: plain calls {s_plain}")
            check(band[0] <= s_acc <= band[1], f"split-tail-path {label}: "
                  f"test accuracy {s_acc} outside {band}")
            kld = float(s_info["train_KL_div"][1])
            rel = abs(kld - ref_kld) / abs(ref_kld)
            check(rel <= DP_KLD_RTOL, f"split-tail-path {label}: sweep-1 "
                  f"train KLD {kld} vs the fused fit's {ref_kld}: {rel:.3e}")
            st_counts[label] = s_launches
            print(f"[split-tail-path] ECG200 {label} on cuda, "
                  f"SPLIT_TAIL_CHI = 0: test accuracy {s_acc:.4f} (held "
                  f"to {band}); median sweep "
                  f"{statistics.median(s_info['sweep_seconds'][1:]):.4f} s "
                  f"(after 1 warm sweep); sweep-1 train KLD {kld:.6f} vs the "
                  f"fused fit's {ref_kld:.6f} ({rel:.2e} relative, held to "
                  f"{DP_KLD_RTOL}); launches "
                  f"{ {k: v for k, v in s_launches.items() if v} }; plain "
                  f"calls {sum(s_plain.values())} ({card})", flush=True)
        # where a split-tail sweep's device time goes
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, p_info, _ = mt.fit_mps(Xtr, ytr, opts=mt.MPSOptions(
                verbosity=-1, log_level=-1, nsweeps=1), device="cuda")
            torch.cuda.synchronize()
    finally:
        bk.SPLIT_TAIL_CHI = split_chi
    dev = device_ms(prof)
    busy = sum(dev.values())
    wall = 1e3 * sum(p_info["sweep_seconds"])
    check(busy > 0, "split-tail-profile: no device time traced")
    # K1 and K2 run over a cluster and K1-tail over a grid, never on one
    # block
    check(not any(k in n for n in dev for k in (
        "k1_kernel", "k2_kernel", "k1_tail_kernel")),
          f"split-tail-profile: a one-block K1, K2 or K1-tail ran: "
          f"{list(dev)}")
    parts = {k: sum(v for n, v in dev.items() if kern in n)
             for k, kern in (("k1", "k1_cluster_kernel"),
                             ("k1_tail", "k1_tail_grid_kernel"),
                             ("k2", "k2_cluster_kernel"))}
    print(f"[split-tail-profile] one default sweep with SPLIT_TAIL_CHI = 0: "
          f"device busy {busy:.1f} ms of {wall:.1f} ms sweep wall time "
          f"({100 * busy / wall:.1f} %); " + "; ".join(
              f"{c} {v:.1f} ms ({100 * v / max(busy, 1e-9):.1f} %)"
              for c, v in zip(("K1", "K1-tail", "K2"), parts.values()))
          + f"; the rest {busy - sum(parts.values()):.1f} ms ({card})",
          flush=True)

    # ---- 17. K12c and K12cr over a thread-block cluster --------------------
    cluster_phase(card)

    # ---- 18. K1c and K1c-update over a thread-block cluster ----------------
    k1c_cluster_phase(card, ptxas)

    # ---- 19. K12, K12m and K12mc over a thread-block cluster ---------------
    k12m_cluster_phase(card, ptxas)

    # ---- 20. K1a and K1c-grad over a thread-block cluster ------------------
    k1a_cluster_phase(card, ptxas)

    # ---- 21. K1 and K1b over a thread-block cluster ------------------------
    k1_cluster_phase(card, ptxas)

    # ---- 22. K2, K2c, K2-split and K2c-split over a thread-block cluster ---
    k2_cluster_phase(card, ptxas)

    # ---- 23. K2-env/K2c-env over row tiles, K1-tail/K1c-tail over a grid --
    k2env_k1tail_phase(card, ptxas)

    # ---- 24-27. imputation and analysis after a fit on the card -----------
    impute_phases(card)

    # ---- 28-33. the model import, serialization, the classifier, padded
    # and batched fits, tune and evaluate --------------------------------
    port_api_phases(card)

    # ---- 34-37. the UCR loader, the three-class path, the naive engine
    # and the profiling path ----------------------------------------------
    last_slice_phases(card)

    # bounds of the timed calls: one backward refresh bond (KLD, TSGO, q 1)
    # and an 8-bond block, at the main-path shape, and the complex, ritz and
    # tail ones timed above
    work = {"k12": k12_work(**SHAPE), "k12m": k12_work(**SHAPE, Bb=8),
            "k1": k1_work(**SHAPE), "k2": k2_work(**SHAPE),
            "k12c": k12_work(**SHAPE, q=3, cplx=True),
            "k12mc": k12_work(**SHAPE, Bb=4, refresh=False, cplx=True),
            "k1c": k1_work(**SHAPE, q=3, cplx=True),
            "k2c": k2_work(**SHAPE, cplx=True),
            "k12cr": k12cr_work(**RITZ_SHAPE),
            "k1a": k1a_work(**SHAPE), "k1b": k1b_work(2, 25, 5),
            "k2_split": k2_split_work(2, 25, 5),
            "k2_env": k2_env_work(25, 5, 100),
            "k1c_grad": k1a_work(**SHAPE, cplx=True),
            "k1c_update": k1b_work(2, 25, 5, q=3, cplx=True),
            "k2c_split": k2_split_work(2, 25, 5, cplx=True),
            "k2c_env": k2_env_work(25, 5, 100, cplx=True),
            "k1_tail": k1_tail_work(2, 25, 5),
            "k1c_tail": k1_tail_work(2, 25, 5, cplx=True)}
    real_src = (KERNEL_SRC, "mpstime_tpu/ops/pallas_bond.py")
    cplx_src = (KERNEL_SRC_C, "mpstime_tpu/ops/pallas_bond_c.py")
    rows = (("K12", "k12", real_src, ":863", mse_launches["k12"]),
            ("K12m", "k12m", real_src, ":966", launches["k12m"]),
            ("K1", "k1", real_src, ":419", qr_launches["k1"]),
            ("K2", "k2", real_src, ":748", qr_launches["k2"]),
            ("K12c", "k12c", cplx_src, ":754", c_launches["k12c"]),
            ("K12mc", "k12mc", cplx_src, ":1075", cq_launches["k12mc"]),
            ("K1c", "k1c", cplx_src, ":368", cq_launches["k1c"]),
            ("K2c", "k2c", cplx_src, ":639", cq_launches["k2c"]),
            ("K12cr", "k12cr", cplx_src, ":913", r_launches["k12cr"]),
            ("K1a", "k1a", real_src, ":470", dp_launches["k1a"]),
            ("K1b", "k1b", real_src, ":527", dp_launches["k1b"]),
            ("K2-split", "k2_split", real_src, ":771",
             dp_launches["k2_split"]),
            ("K2-env", "k2_env", real_src, ":784", dp_launches["k2_env"]),
            ("K1c-grad", "k1c_grad", cplx_src, ":448",
             cdp_launches["k1c_grad"]),
            ("K1c-update", "k1c_update", cplx_src, ":464",
             cdp_launches["k1c_update"]),
            ("K2c-split", "k2c_split", cplx_src, ":654",
             cdp_launches["k2c_split"]),
            ("K2c-env", "k2c_env", cplx_src, ":670",
             cdp_launches["k2c_env"]),
            ("K1-tail", "k1_tail", real_src, ":286",
             st_counts["MPSOptions()"]["k1_tail"]),
            ("K1c-tail", "k1c_tail", cplx_src, ":409",
             st_counts["MPSOptions(encoding='fourier')"]["k1c_tail"]))
    kernels = []
    for name, key, (src, ref_file), line, n in rows:
        b_ms, b_by = bound(work[key])
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": ref_file + line,
            "launches": n, "max_abs_err": err[key], "ms": times[key][0],
            "plain_ms": times[key][1], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
