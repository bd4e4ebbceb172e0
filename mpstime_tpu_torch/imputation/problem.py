"""Imputation problem setup and entry points (counterpart of
``mpstime_tpu/imputation/problem.py``; reference
src/Imputation/imputation.jl).

``init_imputation_problem`` slices the trained label-indexed MPS into per-class
MPSs on the trained model's device, encodes the guess grid there, and returns
an :class:`ImputationProblem`; ``mps_impute`` imputes missing values of a test
instance with the method of choice and computes fit statistics.  The scan
runs in :mod:`.engine`; the host keeps the masks, the transforms and the
statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..encodings import encode_dataset, get_encoding
from ..encodings.pipeline import _pad_enc, encode_rows
from ..models.mps import expand_label_index
from ..options import MPSOptions
from ..training.fit import TrainedMPS
from ..utils.preprocessing import (TransformNorms, _enc_range,
                                   invert_test_transform, transform_test_data,
                                   transform_train_data)
from .engine import ImputeResult, impute_scan, reverse_problem
from .metrics import compute_all_forecast_metrics, mae, mape


@dataclass
class ImputationProblem:
    """Pre-computed state for imputation on a trained MPS
    (reference ImputationProblem + EncodedDataRange, imputation.jl:2-20).
    The tensors live on the trained model's device."""
    cores_full: List[torch.Tensor]     # per class: [T, chi, d, chi], center folded
    X_train: np.ndarray
    y_train: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray
    opts: MPSOptions
    norms: TransformNorms
    enc_args: Any
    grid_x: np.ndarray                 # [G]
    dx: float
    grid_states: List[torch.Tensor]    # per class: [G, d] or [T, G, d]
    timedep: bool
    labels: np.ndarray
    custom_encoding: Any = None
    grid: Optional[torch.Tensor] = None   # grid_x in the scan's real dtype

    def __post_init__(self):
        if self.grid is None:
            self.grid = self.tensor(self.grid_x)

    @property
    def T(self) -> int:
        return self.cores_full[0].shape[0]

    @property
    def num_classes(self) -> int:
        return len(self.cores_full)

    @property
    def device(self) -> torch.device:
        return self.cores_full[0].device

    @property
    def rdtype(self) -> torch.dtype:
        """The scan's real dtype: the cores' precision."""
        return self.cores_full[0].real.dtype

    def class_index(self, label) -> int:
        idx = np.where(self.labels == label)[0]
        if idx.size == 0:
            raise ValueError(f"unknown class label {label!r}; have {self.labels}")
        return int(idx[0])

    def spec(self):
        if self.custom_encoding is not None:
            return self.custom_encoding
        return get_encoding(self.opts.encoding, project=self.opts.projected_basis)

    def class_enc_args(self, ci: int):
        if self.opts.encode_classes_separately and isinstance(self.enc_args, list):
            return self.enc_args[ci]
        return self.enc_args

    def encode_rows(self, X_scaled: np.ndarray, ci: int) -> torch.Tensor:
        """Scaled series [N, T] -> [N, T, d] states of class ci, in the
        cores' dtype on the problem's device."""
        return encode_rows(X_scaled, self.opts, self.enc_args, spec=self.spec(),
                           class_idx=ci, dtype=self.cores_full[0].dtype,
                           device=self.device)

    def tensor(self, a) -> torch.Tensor:
        """A host array in the scan's real dtype on the problem's device."""
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self.rdtype).to(self.device)

    def uniforms(self, rseed: int, shape: Tuple[int, ...],
                 rows: int = 1) -> torch.Tensor:
        """ITS uniforms [rows, *shape] in the scan's real dtype, drawn on the
        problem's device from one generator seeded with ``rseed``, a row at
        a time: row i depends only on (rseed, i), so a run of n trajectories
        starts with the trajectory a run of one draws."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rseed))
        return torch.stack([torch.rand(shape, generator=gen,
                                       dtype=self.rdtype, device=self.device)
                            for _ in range(rows)])

    # ------------------------------------------------------------------
    def run(self, ci: int, method: str, impute_order: str,
            phis_c: torch.Tensor, known_mask: np.ndarray,
            known_x: torch.Tensor, x_prev0: torch.Tensor, *,
            uniforms: Optional[torch.Tensor] = None, want_cdf: bool = False,
            get_err: bool = True, max_jump: Optional[float] = None,
            rejection_threshold=None) -> ImputeResult:
        """The engine's scan over class ci for a batch that shares
        ``known_mask`` [T] (host): phis_c [B, T, d], known_x [B, T], x_prev0
        [B] and ``uniforms`` [B, T(, trials)] in site order.  Under
        impute_order='backwards' the scan walks the reversed sites and the
        results come back in site order."""
        if rejection_threshold in (None, "none", ":none"):
            rejection_threshold = None
        cores = self.cores_full[ci]
        gs = self.grid_states[ci]
        T = self.T
        known_mask = np.asarray(known_mask, dtype=bool)
        backwards = impute_order == "backwards"
        if backwards:
            cores = reverse_problem(cores)
            phis_c, known_x = torch.flip(phis_c, (1,)), torch.flip(known_x, (1,))
            known_mask = known_mask[::-1]
            if self.timedep:
                # site axis reversed: time-dependent grid states follow
                gs = torch.flip(gs, (0,))
        elif impute_order != "forwards":
            raise ValueError("impute_order must be 'forwards' or 'backwards'")

        encode_at = None
        if method == "mean":
            spec, args, d = self.spec(), self.class_enc_args(ci), self.opts.d
            dtype = cores.dtype
            if self.timedep:
                def encode_at(x, t):
                    # a time-dependent basis at the ORIGINAL site T-1-t
                    # under backwards (reverse_t in the JAX engine)
                    tt = (T - 1 - t) if backwards else t
                    xx = torch.zeros((x.shape[0], T), dtype=x.dtype,
                                     device=x.device)
                    xx[:, tt] = x
                    return _pad_enc(spec.encode_batch(xx, d, args)[:, tt]
                                    .to(dtype), self.opts)
            else:
                def encode_at(x, t):
                    return _pad_enc(spec.encode_batch(x[:, None], d, args)
                                    [:, 0].to(dtype), self.opts)

        res = impute_scan(
            cores, phis_c, known_mask, known_x, x_prev0,
            self.grid, self.dx, gs, method=method,
            timedep=self.timedep, want_cdf=want_cdf, get_err=get_err,
            max_jump=max_jump, rejection_threshold=rejection_threshold,
            uniforms=uniforms, encode_at=encode_at)
        if backwards:
            res = ImputeResult(*(None if r is None else torch.flip(r, (1,))
                                 for r in res))
        return res


def init_imputation_problem(mps: TrainedMPS, X_test: np.ndarray,
                            y_test: Optional[np.ndarray] = None,
                            custom_encoding=None, *,
                            dx: float = 1e-4,
                            guess_range: Optional[Tuple[float, float]] = None,
                            verbosity: int = 1,
                            test_encoding: bool = True) -> ImputationProblem:
    """Initialise an imputation problem from a trained MPS
    (reference init_imputation_problem, imputation.jl:48-196), on the
    trained model's device."""
    X_test = np.asarray(X_test, dtype=np.float64)
    if y_test is None:
        y_test = np.zeros(X_test.shape[0], dtype=np.int64)
    y_test = np.asarray(y_test)
    opts = mps.opts
    spec = custom_encoding if custom_encoding is not None else mps.encoding_spec()
    if custom_encoding is not None and opts.encoding != "custom":
        raise ValueError("To impute with a custom encoding, the MPS must have "
                         "been trained with encoding='custom'")

    train = mps.train_data
    if len(train) == 0:
        raise ValueError(
            "init_imputation_problem needs the model's training set; a model "
            "converted with TrainedMPS.from_numpy carries it only when given "
            "X_train= and y_train=")
    X_train, y_train = train.X_orig, train.labels[train.y_idx]
    device = mps.mps.device
    dtype = mps.mps.dtype

    if test_encoding:
        # verify the stored encoding args reproduce the training states
        # (reference imputation.jl:165-187)
        X_train_scaled, _ = transform_train_data(X_train, opts)
        ds = encode_dataset(X_train, X_train_scaled, y_train, opts, spec=spec,
                            labels=train.labels,
                            training_enc_args=train.enc_args,
                            dtype=opts.resolved_dtype(), device=device)
        enc_diff = float(torch.max(torch.abs(ds.X_enc - train.X_enc)))
        if enc_diff > 1e-5:
            raise RuntimeError(
                "Could not reproduce the encoded training set from the "
                "TrainedMPS. If using a custom encoding, double check it "
                "matches the encoding the MPS was trained with.")

    if guess_range is None:
        guess_range = spec.range
    a, b = guess_range
    G = int(round((b - a) / dx)) + 1
    grid_x = np.linspace(a, b, G)

    mpss = expand_label_index(mps.mps)
    cores_full = [m.folded_cores() for m in mpss]
    T = mps.mps.T

    if verbosity > 0:
        print(f" - Dataset has {X_train.shape[0]} training samples and "
              f"{X_test.shape[0]} testing samples.")
        print(f" - {len(mpss)} class(es) were detected.")
        print(f" - {'Time dependent' if spec.is_time_dependent else 'Time independent'} "
              f"encoding - {spec.name} - detected.")
        print(f" - d = {opts.d}, chi_max = {opts.chi_max}")

    # the guess grid's encodings (reference EncodedDataRange,
    # imputation.jl:90-109), float64 on the device, cast once
    timedep = spec.is_time_dependent
    grid = torch.from_numpy(grid_x).to(device)
    grid_states = []
    n_cls = len(mpss)
    for ci in range(n_cls):
        args = train.enc_args[ci] if (opts.encode_classes_separately and
                                      isinstance(train.enc_args, list)) \
            else train.enc_args
        # padded trials (opts.pad_to): zero features up to the padded d
        if timedep:
            enc = spec.encode_batch(grid[:, None].expand(G, T), opts.d, args)
            grid_states.append(_pad_enc(enc.to(dtype), opts).transpose(0, 1)
                               .contiguous())
        else:
            enc = spec.encode_batch(grid[None, :], opts.d, args)
            grid_states.append(_pad_enc(enc[0].to(dtype), opts))    # [G, d]
        if not opts.encode_classes_separately:
            grid_states = grid_states * n_cls
            break

    return ImputationProblem(
        cores_full=cores_full, X_train=X_train, y_train=y_train,
        X_test=X_test, y_test=y_test, opts=opts, norms=mps.norms,
        enc_args=train.enc_args, grid_x=grid_x, dx=float(dx),
        grid_states=grid_states, timedep=timedep, labels=train.labels,
        custom_encoding=custom_encoding)


# ---------------------------------------------------------------------------


def kNN_impute(imp: ImputationProblem, class_label, instance: int,
               missing_sites: Sequence[int], k: int = 1) -> List[np.ndarray]:
    """k nearest neighbours in the training set by Euclidean distance on the
    known sites (reference kNN_impute, imputation.jl:215-262)."""
    missing_sites = np.asarray(missing_sites)
    cl_inds = np.where(imp.y_test == class_label)[0]
    target = imp.X_test[cl_inds[instance]]
    known = np.setdiff1d(np.arange(imp.T), missing_sites)
    c_inds = np.where(imp.y_train == class_label)[0]
    Xc = imp.X_train[c_inds][:, known]
    mses = np.mean((Xc - target[known]) ** 2, axis=1)
    order = np.argsort(mses, kind="stable")[:k]
    return [imp.X_train[c_inds[i]].copy() for i in order]


def _sigmoid_domain_ok(v: np.ndarray, oob, norms, opts) -> bool:
    """Check whether inverting ``v`` stays inside the sigmoid domain (0,1)
    (the reference raises a DomainError there, imputation.jl:344-348)."""
    if not (opts.sigmoid_transform and norms.sigmoid_median is not None):
        return True
    a, b = _enc_range(opts)
    y = (np.asarray(v, dtype=np.float64) - a) / (b - a)
    if oob:
        _, shift, scale = oob[0]
        y = y * scale + shift
    if opts.minmax and norms.minmax_min is not None:
        lb, ub = opts.data_bounds
        y = (y - lb) / (ub - lb)
    f = y[np.isfinite(y)]
    return bool(np.all(f > 0) and np.all(f < 1))


def _invert_with_salvage(ts: np.ndarray, err: np.ndarray, oob, norms, opts,
                         verbosity: int = 0):
    """Invert error bars through the nonlinear transform, NaN-ing values too
    large to invert (reference salvage loop, imputation.jl:343-384)."""
    shifted = err + ts
    if _sigmoid_domain_ok(shifted, oob, norms, opts):
        return invert_test_transform(shifted, oob, norms, opts)

    if verbosity > -1:
        print("Warning: imputation error was too large to transform back into "
              "unnormalised units; returning problematic error values as NaNs "
              "(reference behavior, imputation.jl:343-384).")
    bad = []
    work = shifted.copy()
    for _ in range(len(work)):
        ei = int(np.nanargmax(np.abs(work - ts)))
        bad.append(ei)
        work[ei] = ts[ei]
        if _sigmoid_domain_ok(work, oob, norms, opts):
            break
    inv = invert_test_transform(work, oob, norms, opts)
    inv[np.asarray(bad, dtype=int)] = np.nan
    return inv


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def get_predictions(imp: ImputationProblem, class_label, instance: int,
                    missing_sites: Sequence[int], method: str = "median",
                    impute_order: str = "forwards",
                    invert_transform: bool = True, **kwargs):
    """Impute one test instance; returns (ts_list, err_list, target)
    (reference get_predictions, imputation.jl:264-410)."""
    missing_sites = np.asarray(missing_sites, dtype=int)
    ci = imp.class_index(class_label)
    opts = imp.opts
    cl_inds = np.where(imp.y_test == class_label)[0]
    target_raw = imp.X_test[cl_inds[instance]].astype(np.float64)
    T = imp.T

    # scale the target; blank the missing region with the train mean first so
    # it cannot leak (reference imputation.jl:290)
    target_filled = target_raw.copy()
    target_filled[missing_sites] = float(np.mean(imp.X_train))
    target_full_scaled, _ = transform_test_data(target_raw, imp.norms, opts)
    target_scaled, oob = transform_test_data(target_filled, imp.norms, opts)

    method = method.lstrip(":")
    if method in ("kNearestNeighbour", "knn", "kNN"):
        ts = kNN_impute(imp, class_label, instance, missing_sites,
                        k=kwargs.get("k", 1))
        if not invert_transform:
            ts = [transform_test_data(t, imp.norms, opts)[0] for t in ts]
        return ts, [None] * len(ts), target_raw

    if method == "flatBaseline":
        t0 = target_raw.copy()
        t0[missing_sites] = float(np.mean(imp.X_train))
        ts = [t0]
        if not invert_transform:
            ts = [transform_test_data(t, imp.norms, opts)[0] for t in ts]
        return ts, [None], target_raw

    mname = {"median": "median", "mean": "mean", "mode": "mode",
             "ITS": "its", "its": "its"}.get(method)
    if mname is None:
        raise ValueError("Invalid method. Choose mean, mode, median, ITS, "
                         "kNearestNeighbour or flatBaseline")

    known_mask = np.ones(T, dtype=bool)
    known_mask[missing_sites] = False
    m_sorted = np.sort(missing_sites)
    prev_idx = m_sorted[0] - 1 if impute_order == "forwards" \
        else m_sorted[-1] + 1
    x_prev0 = float(target_scaled[prev_idx]) if 0 <= prev_idx < T and \
        known_mask[prev_idx] else float("nan")

    kern_kwargs: Dict[str, Any] = {}
    if mname == "median":
        kern_kwargs["get_err"] = kwargs.get("get_wmad", True)
    if mname == "mean":
        kern_kwargs["get_err"] = kwargs.get("get_std", True)
    if mname == "mode":
        kern_kwargs["max_jump"] = kwargs.get("max_jump")
        kern_kwargs["get_err"] = False
    if mname == "its":
        kern_kwargs["rejection_threshold"] = kwargs.get("rejection_threshold")
        kern_kwargs["get_err"] = False

    # every trajectory of ITS in ONE batched scan (the reference runs
    # impute_ITS's trajectory loop sequentially, MPS_methods.jl:304-347)
    n_traj = kwargs.get("num_trajectories", 1) if mname == "its" else 1
    phis_c = imp.encode_rows(target_scaled[None], ci).conj()
    uniforms = None
    if mname == "its":
        trials = () if kern_kwargs["rejection_threshold"] in \
            (None, "none", ":none") else (kwargs.get("max_trials", 10),)
        uniforms = imp.uniforms(kwargs.get("rseed", 1), (T,) + trials,
                                rows=n_traj)
    res = imp.run(ci, mname, impute_order,
                  phis_c.expand(n_traj, -1, -1),
                  known_mask, imp.tensor(target_scaled).expand(n_traj, -1),
                  imp.tensor(np.full(n_traj, x_prev0)), uniforms=uniforms,
                  **kern_kwargs)
    xs_all, errs_all = _host(res.x_samps), _host(res.errs)
    ts_list = list(xs_all)
    err_list = list(errs_all)
    has_err = mname in ("median", "mean") and kern_kwargs.get("get_err", True)

    if invert_transform:
        out_ts, out_err = [], []
        for xs, errs in zip(ts_list, err_list):
            inv = invert_test_transform(xs, oob, imp.norms, opts)
            if has_err:
                inv_err = _invert_with_salvage(xs, errs, oob, imp.norms, opts,
                                               verbosity=0) - inv
            else:
                inv_err = None
            out_ts.append(inv)
            out_err.append(inv_err)
        return out_ts, out_err, target_raw

    err_out = [e if has_err else None for e in err_list]
    return ts_list, err_out, target_full_scaled


def mps_impute(imp: ImputationProblem, class_label, instance: int,
               missing_sites: Sequence[int], method: str = "median", *,
               invert_transform: bool = True, impute_order: str = "forwards",
               NN_baseline: bool = True, n_baselines: int = 1,
               plot_fits: bool = False, get_metrics: bool = True,
               full_metrics: bool = False, print_metric_table: bool = False,
               **kwargs):
    """Impute missing values of one instance (reference MPS_impute,
    imputation.jl:467-550).

    Returns (ts, pred_err, target, stats, plots)."""
    missing_sites = np.asarray(missing_sites, dtype=int)
    ts, pred_err, target = get_predictions(
        imp, class_label, instance, missing_sites, method,
        impute_order=impute_order, invert_transform=invert_transform, **kwargs)

    plots = []
    if plot_fits:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(10, 5))
            for i, t in enumerate(ts):
                if pred_err[i] is not None:
                    ax.fill_between(np.arange(len(t)), t - np.nan_to_num(pred_err[i]),
                                    t + np.nan_to_num(pred_err[i]), alpha=0.2)
                ax.plot(t, ls=":", lw=2, label=f"MPS imputed {i+1}")
            ax.plot(target, c="orange", lw=2, alpha=0.7, label="Ground Truth")
            ax.set_xlabel("time")
            ax.set_ylabel("x")
            ax.set_title(f"Sample {instance}, class {class_label}, "
                         f"{len(missing_sites)}-site imputation ({method})")
            ax.legend()
            plots = [fig]
        except ImportError:
            plots = []

    stats: List[Dict[str, float]] = []
    if get_metrics:
        for t in ts:
            if full_metrics:
                stats.append(compute_all_forecast_metrics(
                    t[missing_sites], target[missing_sites], print_metric_table))
            else:
                stats.append({"MAE": mae(t[missing_sites], target[missing_sites]),
                              "MAPE": mape(t[missing_sites], target[missing_sites])})

    if NN_baseline:
        nn_ts, _, _ = get_predictions(imp, class_label, instance, missing_sites,
                                      "kNearestNeighbour",
                                      invert_transform=invert_transform,
                                      k=n_baselines)
        if plot_fits and plots:
            ax = plots[0].axes[0]
            for i, t in enumerate(nn_ts):
                ax.plot(t, c="red", lw=2, alpha=0.7, ls=":",
                        label=f"Nearest Train Data {i+1}")
            ax.legend()
        if get_metrics and stats:
            if full_metrics:
                nn_m = compute_all_forecast_metrics(
                    nn_ts[0][missing_sites], target[missing_sites],
                    print_metric_table)
                for k, v in nn_m.items():
                    stats[0][f"NN_{k}"] = v
            else:
                stats[0]["NN_MAE"] = mae(nn_ts[0][missing_sites],
                                         target[missing_sites])
                stats[0]["NN_MAPE"] = mape(nn_ts[0][missing_sites],
                                           target[missing_sites])

    return ts, pred_err, target, stats, plots


def impute_batch(imp: ImputationProblem, class_label,
                 instances: Sequence[int], missing_sites: Sequence[int],
                 method: str = "median", *, rseed: int = 1,
                 invert_transform: bool = True, **kwargs):
    """Impute the SAME missing pattern across many instances of one class in
    one batched scan (the hyperopt ImputationLoss hot path — the reference
    loops MPS_impute per instance, hyperopt_utils.jl:215-227).

    Returns (ts [B, T] imputed series, targets [B, T] ground truth).
    Delegates to :func:`impute_windows` with a single window."""
    ts, targets = impute_windows(imp, class_label, instances,
                                 [missing_sites], method, rseed=rseed,
                                 invert_transform=invert_transform, **kwargs)
    return ts[0], targets


def _method_kernel_kwargs(method: str, kwargs) -> Tuple[str, Dict]:
    mname = {"median": "median", "mean": "mean", "mode": "mode",
             "ITS": "its", "its": "its"}[method.lstrip(":")]
    kern_kwargs: Dict[str, Any] = {"get_err": False}
    if mname == "mode":
        kern_kwargs["max_jump"] = kwargs.get("max_jump")
    if mname == "its":
        kern_kwargs["rejection_threshold"] = kwargs.get("rejection_threshold")
    return mname, kern_kwargs


def impute_windows(imp: ImputationProblem, class_label,
                   instances: Sequence[int],
                   windows: Sequence[Sequence[int]],
                   method: str = "median", *, rseed: int = 1,
                   invert_transform: bool = True, **kwargs):
    """Impute MANY missing-site windows across many instances of one class,
    with one copy to the device and one back.

    The targets of every window are encoded at once; each window then runs
    one batched scan over the instances with its own known-site mask, so
    known sites do no guess-grid work (the reference's nested sequential
    (instance, window) loop, hyperopt_utils.jl:201-227).

    Returns (ts [W, B, T] imputed series in data units, targets [B, T]).

    ``pad_b_to``: round the instance-batch axis up to a multiple (repeating
    the last instance; padded rows are dropped from the result), as the JAX
    package does so that CV folds share one compiled program.
    """
    windows = [np.asarray(w, dtype=int) for w in windows]
    instances = np.asarray(instances, dtype=int)
    pad_b_to = kwargs.pop("pad_b_to", None)
    n_real = len(instances)
    if pad_b_to:
        npad = (-n_real) % int(pad_b_to)
        if npad:
            instances = np.concatenate([instances,
                                        np.repeat(instances[-1:], npad)])
    ci = imp.class_index(class_label)
    opts = imp.opts
    T = imp.T
    W = len(windows)
    cl_inds = np.where(imp.y_test == class_label)[0]
    targets_raw = imp.X_test[cl_inds[instances]].astype(np.float64)   # [B, T]
    B = targets_raw.shape[0]
    fill = float(np.mean(imp.X_train))

    filled = np.tile(targets_raw[None], (W, 1, 1))
    known = np.ones((W, T), dtype=bool)
    for iw, sites in enumerate(windows):
        filled[iw][:, sites] = fill
        known[iw, sites] = False
    scaled_flat, oob = transform_test_data(filled.reshape(W * B, T),
                                           imp.norms, opts)
    scaled = scaled_flat.reshape(W, B, T)

    x_prev0 = np.full((W, B), np.nan)
    for iw, sites in enumerate(windows):
        m0 = int(np.sort(sites)[0]) - 1
        if m0 >= 0 and known[iw, m0]:
            x_prev0[iw] = scaled[iw, :, m0]

    mname, kern_kwargs = _method_kernel_kwargs(method, kwargs)
    phis_c = imp.encode_rows(scaled_flat, ci).conj().reshape(W, B, T, -1)
    known_x, xp = imp.tensor(scaled), imp.tensor(x_prev0)
    uniforms = None
    if mname == "its":
        trials = () if kern_kwargs["rejection_threshold"] in \
            (None, "none", ":none") else (kwargs.get("max_trials", 10),)
        uniforms = imp.uniforms(rseed, (W, B, T) + trials)[0]
    xs = torch.stack([
        imp.run(ci, mname, "forwards", phis_c[iw], known[iw], known_x[iw],
                xp[iw], uniforms=None if uniforms is None else uniforms[iw],
                **kern_kwargs).x_samps
        for iw in range(W)])
    xs = _host(xs).reshape(W * B, T)
    if not invert_transform:
        return (xs.reshape(W, B, T)[:, :n_real],
                transform_test_data(targets_raw, imp.norms,
                                    opts)[0][:n_real])
    out = invert_test_transform(xs, oob, imp.norms, opts)
    return out.reshape(W, B, T)[:, :n_real], targets_raw[:n_real]


def sample_trajectories(trained, class_label=None, n: int = 1, *,
                        rseed: int = 1, dx: float = 1e-3,
                        rejection_threshold=None, max_trials: int = 10,
                        invert_transform: bool = True) -> np.ndarray:
    """Sample whole synthetic series from a trained MPS's learned joint
    distribution: inverse-transform sampling with every site missing
    (the unconditional limit of the imputation engine), all n trajectories
    in one batched scan.

    Returns [n, T] trajectories in data units (or scaled units when
    ``invert_transform=False``)."""
    if not isinstance(trained, TrainedMPS):
        raise TypeError("sample_trajectories expects a TrainedMPS")
    if class_label is None:
        class_label = trained.labels[0]
    T = trained.mps.T
    # one dummy test instance of the requested class; all sites missing
    dummy = np.tile(np.mean(trained.train_data.X_orig, axis=0), (1, 1))
    imp = init_imputation_problem(
        trained, dummy, np.asarray([class_label]), dx=dx, verbosity=-1,
        test_encoding=False)
    ts, _, _ = get_predictions(
        imp, class_label, 0, np.arange(T), "ITS",
        invert_transform=invert_transform, rseed=rseed, num_trajectories=n,
        rejection_threshold=rejection_threshold, max_trials=max_trials)
    return np.stack(ts)


def get_cdfs(imp: ImputationProblem, class_label, instance: int,
             missing_sites: Sequence[int], **kwargs):
    """Median-impute and return the per-site conditional CDFs
    (reference get_cdfs, imputation.jl:581-622).

    Returns (cdfs [n_missing, G], ts, pred_err, target_full_scaled)."""
    missing_sites = np.asarray(missing_sites, dtype=int)
    ci = imp.class_index(class_label)
    opts = imp.opts
    cl_inds = np.where(imp.y_test == class_label)[0]
    target_raw = imp.X_test[cl_inds[instance]].astype(np.float64)
    T = imp.T

    target_filled = target_raw.copy()
    target_filled[missing_sites] = float(np.mean(imp.X_test))
    target_full_scaled, _ = transform_test_data(target_raw, imp.norms, opts)
    target_scaled, oob = transform_test_data(target_filled, imp.norms, opts)

    known_mask = np.ones(T, dtype=bool)
    known_mask[missing_sites] = False
    m0 = np.sort(missing_sites)[0] - 1
    x_prev0 = float(target_scaled[m0]) if m0 >= 0 and known_mask[m0] else float("nan")

    res = imp.run(ci, "median", "forwards",
                  imp.encode_rows(target_scaled[None], ci).conj(), known_mask,
                  imp.tensor(target_scaled[None]), imp.tensor([x_prev0]),
                  want_cdf=True, get_err=kwargs.get("get_wmad", True))
    cdfs = _host(res.cdfs[0])[np.sort(missing_sites)]
    return cdfs, [_host(res.x_samps[0])], [_host(res.errs[0])], \
        target_full_scaled
