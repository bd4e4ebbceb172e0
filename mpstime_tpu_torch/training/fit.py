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
from ..utils.preprocessing import TransformNorms, transform_data
from .stats import loss_acc_conf
from .sweep import full_sweeps


@dataclass
class TrainedMPS:
    """Trained MPS + options + training-data record (reference
    ``TrainedMPS``, options.jl:422-427): everything needed to re-encode new
    data."""
    mps: MPS
    opts: MPSOptions
    norms: TransformNorms
    train_data: EncodedDataset

    @property
    def labels(self) -> np.ndarray:
        return self.train_data.labels

    def encoding_spec(self) -> EncodingSpec:
        return get_encoding(self.opts.encoding, project=self.opts.projected_basis)

    @classmethod
    def from_numpy(cls, cores: np.ndarray, center: np.ndarray,
                   center_pos: int, opts, norms, labels,
                   enc_args=None, device="cpu") -> "TrainedMPS":
        """Weight converter: a TrainedMPS from a JAX model's host arrays.

        ``opts``: this package's MPSOptions, or the JAX options' JSON
        (``jax_trained.opts.to_json()``); ``norms``: a TransformNorms or its
        dict (``jax_trained.norms.to_dict()``); ``labels``: the sorted class
        labels; ``enc_args``: the encoding's training arguments (None for
        the closed-form bases).  Enough to classify new data; the training
        set itself is not carried over."""
        if isinstance(opts, str):
            opts = MPSOptions.from_json(opts)
        if isinstance(norms, dict):
            norms = TransformNorms.from_dict(norms)
        mps = MPS.from_numpy(cores, center, center_pos, device)
        labels = np.asarray(labels)
        tdt = mps.dtype
        train = EncodedDataset(
            torch.zeros((0, mps.T, mps.d), dtype=tdt, device=mps.device),
            np.zeros(0, np.int64), labels, np.zeros((0, mps.T)),
            np.zeros((0, mps.T)), np.zeros(len(labels), np.int64), enc_args)
        return cls(mps, opts, norms, train)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def fit_mps(X_train: np.ndarray, y_train: Optional[np.ndarray] = None,
            X_test: Optional[np.ndarray] = None,
            y_test: Optional[np.ndarray] = None,
            opts: MPSOptions = None,
            custom_encoding: Optional[EncodingSpec] = None,
            mesh=None, test_run: bool = False,
            pad_samples_to: Optional[int] = None, device="cpu"
            ) -> Tuple[TrainedMPS, Dict[str, list], EncodedDataset]:
    """Train a label-indexed MPS (reference fitMPS :383).

    X_train: [N, T] series as rows.  y_train defaults to all zeros
    (unsupervised).  X_test/y_test are only used for evaluation logging.
    ``device``: where the sweeps run ("cpu" or "cuda"); "cuda" runs the
    hand-written bond kernels and raises where no GPU is present.  Returns
    (trained, info, encoded_test_states); the test states are class-sorted.
    ``info["sweep_seconds"]`` holds each sweep's wall time, ended by a
    device synchronisation."""
    if mesh is not None:
        raise _not_ported("mesh= (data-parallel training)", "queue 1 item 16")
    if test_run:
        raise _not_ported("test_run=True (basis preview)", "queue 1 item 18")
    if custom_encoding is not None:
        raise _not_ported("custom_encoding=", "queue 1 item 4")
    if opts is None:
        opts = MPSOptions()
    if opts.pad_to is not None or pad_samples_to:
        raise _not_ported("pad_to / pad_samples_to (padded hyperopt trials)",
                          "queue 1 item 18")
    if opts.track_cost:
        raise _not_ported("track_cost=True", "queue 1 item 10")
    device = torch.device(device)
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

    spec = get_encoding(opts.encoding, project=opts.projected_basis)
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
    mps = random_mps(opts.init_rng, T, opts.d, num_classes, opts.chi_init,
                     opts.chi_max, dtype=dtype, device=device)

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

    info: Dict[str, list] = {k: [] for k in
                             ("train_loss", "train_acc", "train_KL_div",
                              "test_loss", "test_acc", "test_KL_div",
                              "test_conf", "time_taken", "sweep_seconds")}
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
    sweep_kw = dict(loss=opts.loss_grad, bbopt=opts.bbopt,
                    update_iters=opts.update_iters, rescale=opts.rescale,
                    svd_alg=opts.resolved_svd_alg(device),
                    power_iters=opts.resolved_power_iters(device),
                    orth=opts.resolved_orth_alg(device))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    clock = [time.perf_counter()]

    def on_sweep(i: int, cores: torch.Tensor, center: torch.Tensor) -> bool:
        sync()
        elapsed = time.perf_counter() - clock[0]
        info["sweep_seconds"].append(elapsed)
        m = MPS(cores, center, T - 1)
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
        mps.cores, mps.center, phis_c, y_onehot, class_weight, opts.eta,
        opts.cutoff, nsweeps=opts.nsweeps,
        refresh_every=opts.subspace_refresh_every, on_sweep=on_sweep,
        **sweep_kw)
    mps = MPS(cores, center, T - 1).normalize()
    if verb > -1:
        print("\nMPS normalised!\n")
    if opts.log_level > 0:
        log_stats(mps, float("nan"))

    trained = TrainedMPS(mps, opts, norms, train_ds)
    return trained, info, test_ds
