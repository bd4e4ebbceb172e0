"""fit_mps, the training entry point (counterpart of
``mpstime_tpu/training/fit.py``; reference fitMPS,
RealRealHighDimension.jl:383-890).

Pipeline: preprocess (host numpy) -> encode -> seeded random MPS -> nsweeps
full sweeps on ``device`` -> per-sweep stats -> TrainedMPS.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..encodings import EncodedDataset, EncodingSpec, encode_dataset, get_encoding
from ..models.mps import MPS, random_mps
from ..options import MPSOptions, torch_dtype
from ..utils.preprocessing import (TransformNorms, transform_data,
                                   transform_train_data)
from .stats import loss_acc_conf
from .sweep import full_sweeps, pallas_route_notice


@dataclass
class TrainedMPS:
    """Trained MPS + options + training-data record (reference
    ``TrainedMPS``, options.jl:422-427): everything needed to re-encode new
    data."""
    mps: MPS
    opts: MPSOptions
    norms: TransformNorms
    train_data: EncodedDataset
    custom_encoding: Optional[EncodingSpec] = None

    @property
    def labels(self) -> np.ndarray:
        return self.train_data.labels

    def encoding_spec(self) -> EncodingSpec:
        if self.custom_encoding is not None:
            return self.custom_encoding
        return get_encoding(self.opts.encoding, project=self.opts.projected_basis)

    @classmethod
    def from_numpy(cls, cores: np.ndarray, center: np.ndarray,
                   center_pos: int, opts, norms, labels,
                   enc_args=None, device="cuda", *,
                   X_train: Optional[np.ndarray] = None,
                   y_train: Optional[np.ndarray] = None,
                   custom_encoding: Optional[EncodingSpec] = None
                   ) -> "TrainedMPS":
        """Weight converter: a TrainedMPS from a JAX model's host arrays.

        ``opts``: this package's MPSOptions, or the JAX options' JSON
        (``jax_trained.opts.to_json()``); ``norms``: a TransformNorms or its
        dict (``jax_trained.norms.to_dict()``); ``labels``: the sorted class
        labels; ``enc_args``: the encoding's training arguments (None for
        the closed-form bases; host numpy for the data-driven ones, a list
        of them per class under ``encode_classes_separately``).

        Without ``X_train`` the model classifies new data and the training
        set is left empty.  With ``X_train`` (and ``y_train``, the raw
        training series and labels, e.g. ``jax_trained.train_data.X_orig``
        and ``labels[y_idx]``) the training record is rebuilt through this
        package's ``transform_train_data`` and ``encode_dataset`` with the
        given ``enc_args``, in the same class-sorted order, so the model
        also imputes (``init_imputation_problem`` reads it)."""
        if isinstance(opts, str):
            opts = MPSOptions.from_json(opts)
        if isinstance(norms, dict):
            norms = TransformNorms.from_dict(norms)
        mps = MPS.from_numpy(cores, center, center_pos, device)
        labels = np.asarray(labels)
        if X_train is None:
            train = EncodedDataset(
                torch.zeros((0, mps.T, mps.d), dtype=mps.dtype,
                            device=mps.device),
                np.zeros(0, np.int64), labels, np.zeros((0, mps.T)),
                np.zeros((0, mps.T)), np.zeros(len(labels), np.int64),
                enc_args)
        else:
            X_train = np.asarray(X_train, dtype=np.float64)
            y_train = (np.full(X_train.shape[0], labels[0]) if y_train is None
                       else np.asarray(y_train))
            X_scaled, _ = transform_train_data(X_train, opts)
            spec = (custom_encoding if custom_encoding is not None else
                    get_encoding(opts.encoding, project=opts.projected_basis))
            train = encode_dataset(X_train, X_scaled, y_train, opts, spec=spec,
                                   labels=labels, training_enc_args=enc_args,
                                   dtype=opts.resolved_dtype(),
                                   device=mps.device)
        return cls(mps, opts, norms, train, custom_encoding)


def _not_ported(what: str, module: str):
    return NotImplementedError(f"{what} is not ported yet: it waits for the "
                               f"port of mpstime_tpu's {module}")


def _pad_sample_axis(phis_c, y_onehot, class_weight, npad: int):
    """Pad the sample axis with ``npad`` zero-weight copies of the first
    sample (fit.py:48-60): every contraction stays finite (a zero-filled row
    would give the KLD weight 0/0) while the copies add nothing to the loss
    or the gradient."""
    if not npad:
        return phis_c, y_onehot, class_weight
    return (torch.cat([phis_c, phis_c[:, :1].expand(-1, npad, -1)], dim=1),
            torch.cat([y_onehot, y_onehot[:1].expand(npad, -1)]),
            torch.cat([class_weight, class_weight.new_zeros(npad)]))


def fit_mps(X_train: np.ndarray, y_train: Optional[np.ndarray] = None,
            X_test: Optional[np.ndarray] = None,
            y_test: Optional[np.ndarray] = None,
            opts: MPSOptions = None,
            custom_encoding: Optional[EncodingSpec] = None,
            mesh=None, test_run: bool = False,
            pad_samples_to: Optional[int] = None, device="cuda"
            ) -> Tuple[TrainedMPS, Dict[str, list], EncodedDataset]:
    """Train a label-indexed MPS (reference fitMPS :383).

    X_train: [N, T] series as rows.  y_train defaults to all zeros
    (unsupervised).  X_test/y_test are only used for evaluation logging.
    ``device``: where the sweeps run, the card ("cuda", the default) or
    "cpu"; "cuda" raises where no GPU is present.  On the card the bond-
    kernel route runs the hand-written kernels and every other configuration
    the unfused route in PyTorch (training/sweep.py).  Returns (trained,
    info, encoded_test_states); the test states are class-sorted.
    ``info["sweep_seconds"]`` holds each sweep's wall time, ended by a
    synchronisation of every device the sweep ran on; with
    ``opts.track_cost``, ``info["bond_costs"]`` holds each sweep's per-bond
    loss trace [2(T-1)] in update order.

    ``mesh``: a data-parallel mesh (``parallel.make_mesh()`` over the
    cards, ``parallel.Mesh(["cpu"] * n)`` on the CPU), which replaces
    ``device``: the sample axis is padded with zero-weight copies to a
    multiple of the mesh size and sharded over it, the MPS is replicated,
    and every bond update sums the shards' gradients once.  The trained
    model lives on the mesh's first device.  ``pad_samples_to``: pad the
    sample axis to at least this many rows the same way (before the mesh's
    padding).

    ``opts.pad_to = (chi_cap, d_cap)`` (the padded trials of ``tune``):
    the model is allocated at the caps, the encodings zero-padded to
    d_cap, the samples padded to a multiple of 8 (or ``pad_samples_to``),
    and ``chi_max`` is a runtime rank cap on every split; the split then
    orthogonalises by QR (``MPSOptions.resolved_orth_alg``), so on the
    card every refresh bond runs K1 -> QR -> K2 with the cap.  It does not
    combine with ``mesh``."""
    if test_run:
        raise _not_ported("test_run=True (basis preview)",
                          "vis/vis_encodings.py (plot_encoding)")
    if opts is None:
        opts = MPSOptions()
    if opts.pad_to is not None and mesh is not None:
        raise ValueError("pad_to (shape-polymorphic trials) does not "
                         "combine with mesh sharding; use one or the other")
    device = mesh.devices[0] if mesh is not None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit_mps(device='cuda'): no CUDA device is available")

    X_train = np.asarray(X_train, dtype=np.float64)
    N, T = X_train.shape
    if y_train is None:
        y_train = np.zeros(N, dtype=np.int64)
    y_train = np.asarray(y_train)
    if X_test is None:
        X_test = np.zeros((0, T))
        y_test = np.zeros(0, dtype=y_train.dtype)
    X_test = np.asarray(X_test, dtype=np.float64)
    y_test = np.asarray(y_test)

    if custom_encoding is not None and opts.encoding != "custom":
        raise ValueError("To use a custom encoding, set encoding='custom' in MPSOptions")
    spec = custom_encoding if custom_encoding is not None \
        else get_encoding(opts.encoding, project=opts.projected_basis)
    if custom_encoding is not None and \
            opts.custom_encoding_range != tuple(spec.range):
        # stamp the spec's domain so preprocessing scales into it (it
        # travels with TrainedMPS.opts for classify/impute re-encoding)
        opts = opts.replace(custom_encoding_range=tuple(spec.range))
    dtype = opts.resolved_dtype()
    if spec.is_complex and np.dtype(dtype).kind != "c":
        raise ValueError("Using a complex valued encoding but the MPS dtype is real. "
                         "Set a complex dtype in MPSOptions.")

    labels = np.unique(y_train)
    if np.setdiff1d(np.unique(y_test), labels).size:
        raise ValueError("Test set has classes not present in the training set.")
    num_classes = len(labels)
    verb = opts.verbosity

    # ---- preprocess + encode ---------------------------------------------
    X_train_s, X_test_s, norms, _ = transform_data(X_train, X_test, opts)
    train_ds = encode_dataset(X_train, X_train_s, y_train, opts, spec=spec,
                              labels=labels, dtype=dtype, device=device)
    test_ds = encode_dataset(X_test, X_test_s, y_test, opts, spec=spec,
                             labels=labels, training_enc_args=train_ds.enc_args,
                             dtype=dtype, device=device)

    # ---- init MPS ---------------------------------------------------------
    if verb > -1:
        print(f"Generating initial weight MPS with bond dimension chi_init = "
              f"{opts.chi_init} using random state {opts.init_rng}.")
    # padded trials (MPSOptions.pad_to): allocate at the caps (chi_cap,
    # d_cap) with chi_max as a runtime rank cap, passed on every padded fit
    # as the JAX package always traces it (fit.py:144-158)
    pad = opts.pad_to
    chi_pad = opts.chi_max if pad is None else pad[0]
    max_rank = None if pad is None else opts.chi_max
    mps = random_mps(opts.init_rng, T, opts.d, num_classes, opts.chi_init,
                     chi_pad, dtype=dtype, device=device,
                     pad_d=None if pad is None else pad[1])

    # ---- training tensors -------------------------------------------------
    phis_c = train_ds.X_enc.conj().transpose(0, 1).contiguous()   # [T, N, d]
    y_idx = train_ds.y_idx
    real_dt = torch_dtype(opts.real_dtype())
    y_onehot = torch.nn.functional.one_hot(
        torch.as_tensor(y_idx, device=device), num_classes).to(real_dt)
    counts = train_ds.class_distribution.astype(np.float64)
    w = (1.0 / counts[y_idx] if opts.train_classes_separately
         else np.full(N, 1.0 / N))
    class_weight = torch.as_tensor(w, device=device).to(real_dt)
    if pad is not None or pad_samples_to:
        # zero-weight copies up to pad_samples_to, else (padded trials) to a
        # multiple of 8, as the JAX package's fit does (fit.py:173-180)
        target = max(N, pad_samples_to) if pad_samples_to else N + (-N) % 8
        phis_c, y_onehot, class_weight = _pad_sample_axis(
            phis_c, y_onehot, class_weight, target - N)
    cores, center = mps.cores, mps.center
    if mesh is not None:
        from ..parallel import replicate, shard_train_arrays
        # pad from the current length (pad_samples_to may have grown it), so
        # the shards are equal (fit.py:182-191)
        phis_c, y_onehot, class_weight = shard_train_arrays(
            mesh, *_pad_sample_axis(phis_c, y_onehot, class_weight,
                                    -phis_c.shape[1] % len(mesh)))
        cores, center = replicate(mesh, cores, center)

    info: Dict[str, list] = {k: [] for k in
                             ("train_loss", "train_acc", "train_KL_div",
                              "test_loss", "test_acc", "test_KL_div",
                              "test_conf", "time_taken", "sweep_seconds")}
    if opts.track_cost:
        info["bond_costs"] = []
    has_test = len(test_ds) > 0

    def log_stats(m: MPS, elapsed: float) -> float:
        tr_mse, tr_kld, tr_acc, _ = loss_acc_conf(m, train_ds.X_enc, y_idx)
        info["train_loss"].append(tr_mse)
        info["train_acc"].append(tr_acc)
        info["train_KL_div"].append(tr_kld)
        info["time_taken"].append(elapsed)
        if has_test:
            te_mse, te_kld, te_acc, conf = loss_acc_conf(
                m, test_ds.X_enc, test_ds.y_idx)
            info["test_loss"].append(te_mse)
            info["test_acc"].append(te_acc)
            info["test_KL_div"].append(te_kld)
            info["test_conf"].append(conf)
            if verb > -1:
                print(f"Training KL Div. {tr_kld} | Training acc. {tr_acc}.")
                print(f"Test KL Div. {te_kld} | Testing acc. {te_acc}.")
        elif verb > -1:
            print(f"Training KL Div. {tr_kld} | Training acc. {tr_acc}.")
        return tr_acc

    if verb > -1:
        print(f"Using {opts.update_iters} iterations per update.")
    if opts.log_level > 0:
        log_stats(mps, 0.0)

    # ---- sweeps -----------------------------------------------------------
    # the ritz route's exact -> tracked schedule: sweep i is tracked iff
    # 0 <= ritz_exact_sweeps <= i (fit.py:261-304, sweep.sweep_schedule)
    exact_rot, track_rot = opts.resolved_ritz_rots(device)
    sweep_kw = dict(loss=opts.loss_grad, bbopt=opts.bbopt,
                    update_iters=opts.update_iters, rescale=opts.rescale,
                    svd_alg=opts.resolved_svd_alg(device),
                    power_iters=opts.resolved_power_iters(device),
                    orth=opts.resolved_orth_alg(device),
                    ritz_exact_sweeps=opts.ritz_exact_sweeps,
                    ritz_exact_rot=exact_rot, ritz_track_rot=track_rot)
    if verb >= 1:
        # off the bond kernels a fit runs many small PyTorch operations per
        # bond on the card: say so once
        notice = pallas_route_notice(
            mps.dtype, opts.loss_grad, opts.bbopt, opts.update_iters,
            opts.rescale, sweep_kw["svd_alg"], device,
            track_cost=opts.track_cost, ritz_track_rot=track_rot)
        if notice:
            print(notice)

    def sync():
        if mesh is not None:
            mesh.synchronize()
        elif device.type == "cuda":
            torch.cuda.synchronize(device)

    clock = [time.perf_counter()]

    def on_sweep(i: int, cores: torch.Tensor, center: torch.Tensor,
                 costs: Optional[torch.Tensor]) -> bool:
        sync()
        elapsed = time.perf_counter() - clock[0]
        info["sweep_seconds"].append(elapsed)
        m = MPS(cores, center, T - 1)
        if costs is not None:
            # the whole sweep's per-bond loss trace (reference track_cost
            # prints the cost during updates, loss_functions.jl:50)
            costs = costs.cpu().numpy()
            info["bond_costs"].append(costs)
            if verb >= 1:
                print(f"Sweep {i + 1} bond costs: first {costs[0]:.6g}, "
                      f"last {costs[-1]:.6g}, mean {costs.mean():.6g}")
        if verb > -1:
            print(f"Finished sweep {i + 1}. Time for sweep: {elapsed:.2f}s")
        tr_acc = log_stats(m, elapsed) if opts.log_level > 0 else None
        stop = False
        if opts.exit_early:
            # the reference checks train_acc == 1 every sweep
            # (RealRealHighDimension.jl:847-849)
            if tr_acc is None:
                _, _, tr_acc, _ = loss_acc_conf(m, train_ds.X_enc, y_idx)
            if tr_acc == 1.0:
                if verb > -1:
                    print("Early exit: train accuracy reached 1.0 after "
                          f"sweep {i + 1}.")
                stop = True
        if verb > -1 and not stop and i + 1 < opts.nsweeps:
            print(f"Starting sweep [{i + 2}/{opts.nsweeps}] "
                  f"(optimiser {opts.bbopt}, loss {opts.loss_grad})")
        clock[0] = time.perf_counter()
        return stop

    if verb > -1 and opts.nsweeps > 0:
        print(f"Starting sweep [1/{opts.nsweeps}] "
              f"(optimiser {opts.bbopt}, loss {opts.loss_grad})")
    clock[0] = time.perf_counter()
    cores, center = full_sweeps(
        cores, center, phis_c, y_onehot, class_weight, opts.eta,
        opts.cutoff, nsweeps=opts.nsweeps,
        refresh_every=opts.subspace_refresh_every, max_rank=max_rank,
        track_cost=opts.track_cost, on_sweep=on_sweep, mesh=mesh, **sweep_kw)
    mps = MPS(cores, center, T - 1).normalize()
    if verb > -1:
        print("\nMPS normalised!\n")
    if opts.log_level > 0:
        log_stats(mps, float("nan"))

    trained = TrainedMPS(mps, opts, norms, train_ds, custom_encoding)
    return trained, info, test_ds


# Fields fit_mps_batch allows to differ between jobs: the per-model knobs
# (eta, cutoff, the chi_max rank cap) and the init seed.  Everything else is
# shared, as the JAX package's one batched program requires
# (fit.py:381-384).
_BATCH_VARIABLE_FIELDS = ("eta", "cutoff", "chi_max", "init_rng")


def fit_mps_batch(jobs, opts: MPSOptions = None, opts_list=None,
                  device="cuda") -> list:
    """Train F independent MPS models that share one configuration up to
    their per-model knobs (fit.py:387-527): a padded trial population, or
    the CV folds of one trial.  Each job is one :func:`fit_mps` on
    ``device`` (on the card, through the bond kernels).

    ``jobs``: a list of ``(X_train, y_train)`` pairs sharing T and the label
    set.  ``opts_list``: per-job options differing only in eta / cutoff /
    chi_max / init_rng; pass ``opts`` when all jobs share one configuration.
    ``device``: the card ("cuda", the default) or "cpu".

    The jobs share their caps as in the JAX package's batch: the model is
    allocated at ``opts.pad_to``, else, where the jobs' chi_max differ, at
    (the largest chi_max, d), with each job's chi_max as its rank cap; a
    padded job's samples are padded with zero-weight copies to the largest
    job's count rounded up to 8 (exact for the KLD loss and gradient).
    Every job runs all ``nsweeps``, with no per-sweep logging and no early
    exit; returns a list of TrainedMPS, each carrying its own options."""
    if opts_list is None:
        opts_list = [opts if opts is not None else MPSOptions()] * len(jobs)
    if len(opts_list) != len(jobs):
        raise ValueError("opts_list must match jobs in length")
    if not jobs:
        return []

    def _static_key(o):
        dd = o.to_dict()
        for f in _BATCH_VARIABLE_FIELDS:
            dd.pop(f)
        return dd

    base = _static_key(opts_list[0])
    for o in opts_list[1:]:
        if _static_key(o) != base:
            raise ValueError(
                "fit_mps_batch jobs may differ only in "
                f"{_BATCH_VARIABLE_FIELDS}; other options are shared")
    Xs = [np.asarray(X, np.float64) for X, _ in jobs]
    T = Xs[0].shape[1]
    if any(X.shape[1] != T for X in Xs):
        raise ValueError("all jobs must share the series length T")
    ys = [np.asarray(y) if y is not None else np.zeros(X.shape[0], np.int64)
          for X, (_, y) in zip(Xs, jobs)]
    labels = np.unique(ys[0])
    if any(not np.array_equal(np.unique(y), labels) for y in ys):
        raise ValueError("all jobs must share the label set")

    o0 = opts_list[0]
    chis = [o.chi_max for o in opts_list]
    pad = o0.pad_to
    if pad is None and len(set(chis)) > 1:
        pad = (max(chis), o0.d)
    n_max = max(X.shape[0] for X in Xs)
    pad_samples = None if pad is None else n_max + (-n_max) % 8
    out = []
    for o, X, y in zip(opts_list, Xs, ys):
        trained, _, _ = fit_mps(
            X, y, opts=o.replace(pad_to=pad, log_level=0, exit_early=False,
                                 verbosity=-1),
            pad_samples_to=pad_samples, device=device)
        trained.opts = o
        out.append(trained)
    return out
