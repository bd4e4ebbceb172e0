"""Import TrainedMPS models saved by the Julia reference (MPSTime.jl);
counterpart of ``mpstime_tpu/models/itensor_import.py``, whose HDF5/JLD2
parsing (NumPy plus h5py, imported lazily) it copies.  Only the
re-canonicalised tensors and the re-encoded training set use this
package's ``MPS`` and ``encode_dataset``, on the device the caller names.

MPSTime.jl checkpoints are JLD2 files (an HDF5 dialect) holding a
``TrainedMPS`` — an ITensors ``MPS`` (vector of dense tensors with index
metadata), the ``MPSOptions`` it was trained with, and the training data
record (reference ``TrainedMPS``, src/Structs/options.jl:422-427; JLD2
save/load exercised in test/save_load.jl).  This module parses that layout
with h5py and converts it into this package's padded-core :class:`MPS` +
:class:`TrainedMPS`, so models trained with the Julia package can be
classified / imputed / analysed here directly — and so the test suite can
use a reference-trained model as a cross-implementation oracle.

Layout notes (JLD2 v0.4-era files):
 * compound members are either inline scalars, nested compounds, or HDF5
   object references; JLD2's *type* metadata members (e.g. the ``dtype``
   field) use custom reference types h5py cannot map, so compounds are read
   member-by-member with hand-built partial memory types;
 * an ITensor is ``{storage: {data: ref -> flat f64 vector}, inds: {1..k}}``
   where each index carries ``(id, space=dim, tags, plev)``; tensor data is
   column-major (Julia) in the order of ``inds``;
 * index tags are ITensors SmallStrings: 32 raw bytes per tag holding the
   reversed character sequence ("Site" is stored ...e t i S).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _require_h5py():
    try:
        import h5py
        return h5py
    except ImportError as e:                              # pragma: no cover
        raise ImportError(
            "Importing MPSTime.jl models requires the h5py package") from e


def _read_members(ds, members):
    """Read selected compound members of a scalar dataset via a partial
    memory type (HDF5 matches compound members by name, skipping the
    JLD2-specific ones h5py cannot convert).

    ``members``: list of (name, np_dtype_str) with "ref" for object refs."""
    import h5py
    from h5py import h5s

    def conv(t):
        if t == "ref":
            return h5py.ref_dtype
        if isinstance(t, list):
            return np.dtype([(n, conv(s)) for n, s in t])
        return t

    mem = np.dtype([(n, conv(t)) for n, t in members])
    out = np.empty((), dtype=mem)
    ds.id.read(h5s.ALL, h5s.ALL, out, h5py.h5t.py_create(mem))
    return out


def _tag_str(raw32) -> str:
    """Decode one ITensors SmallString (32 raw bytes, reversed chars)."""
    b = bytes(raw32.tobytes() if hasattr(raw32, "tobytes") else raw32)
    chars = [c for c in b if c != 0]
    return bytes(reversed(chars)).decode(errors="replace")


def _index_info(iv) -> dict:
    tags_raw = iv["tags"]["data"]["data"]
    n = int(iv["tags"]["length"])
    tags = [_tag_str(tags_raw[str(k)]) for k in range(1, n + 1)]
    return dict(id=int(iv["id"]), dim=int(iv["space"]), tags=tags)


def _storage_to_array(ds) -> np.ndarray:
    """Flat data vector of an ITensor storage: plain Float64, or JLD2's
    Complex{Float64} (an HDF5 compound with ``re``/``im`` members,
    reference Structs/options.jl:422-427 — complex models are saved for
    the Fourier/Sahand/Stoudenmire encodings)."""
    raw = ds[()]
    if raw.dtype.names:
        names = set(raw.dtype.names)
        if {"re", "im"} <= names:
            return (np.asarray(raw["re"], np.float64)
                    + 1j * np.asarray(raw["im"], np.float64))
        raise ValueError(
            "Cannot map ITensor storage with compound element type "
            f"{raw.dtype.names!r}: expected Float64 data or "
            "Complex{Float64} (re/im members). Blocked/sparse ITensor "
            "storages are not supported — re-save the reference model as "
            "a dense MPS.")
    if raw.dtype.kind != "f":
        raise ValueError(
            f"Cannot map ITensor storage of element kind {raw.dtype!r}: "
            "expected Float64 or Complex{Float64} dense storage.")
    return np.asarray(raw, dtype=np.float64)


def _read_itensor(f, ref):
    """-> (array in inds order, [index info])."""
    wrapper = f[ref]
    t = f[wrapper.fields("tensor")[()]]
    stor = t.fields("storage")[()]
    flat = _storage_to_array(f[stor["data"]])
    inds_v = t.fields("inds")[()]
    inds = [_index_info(inds_v[name]) for name in inds_v.dtype.names]
    arr = flat.reshape([i["dim"] for i in inds], order="F")
    return arr, inds


def _axis(inds, pred) -> Optional[int]:
    for k, i in enumerate(inds):
        if pred(i):
            return k
    return None



def _deref(f, ref):
    """f[ref] accepting refs wrapped in 0-d object arrays."""
    if isinstance(ref, np.ndarray):
        ref = ref[()]
    return f[ref]

def load_mpstime_jl(path: str, *, key: str = "mps", device="cuda"):
    """Load a ``TrainedMPS`` saved by MPSTime.jl (``@save path mps``) into
    this package's :class:`~mpstime_tpu_torch.training.fit.TrainedMPS`, with
    the cores, center and encoded training set on ``device``.

    The MPS tensors are converted to the padded-core layout (label axis on
    the last site -> the center tensor) and re-canonicalized; options are
    mapped onto :class:`MPSOptions`; the training-data record (original
    series + labels) is re-encoded with this package's pipeline so
    ``classify`` / ``init_imputation_problem`` work directly on the
    imported model.  Both Float64 and ComplexF64 ITensor storage are
    supported (the reference saves ComplexF64 models for its complex
    Fourier/Sahand/Stoudenmire encodings); unmappable storages (blocked /
    sparse / other element types) raise a ValueError naming the layout."""
    h5py = _require_h5py()
    from ..encodings import encode_dataset
    from ..options import MPSOptions
    from ..training.fit import TrainedMPS
    from ..utils.preprocessing import transform_train_data
    from .mps import MPS

    with h5py.File(path, "r") as f:
        top = f[key]

        # ---- options -------------------------------------------------------
        o = _read_members(top, [
            ("opts", [("verbosity", "<i8"), ("nsweeps", "<i8"),
                      ("chi_max", "<i8"), ("eta", "<f8"), ("d", "<i8"),
                      ("encoding", "ref"), ("aux_basis_dim", "<i8"),
                      ("cutoff", "<f8"), ("update_iters", "<i8"),
                      ("projected_basis", "u1"), ("track_cost", "u1"),
                      ("rescale", [("1", "u1"), ("2", "u1")]),
                      ("train_classes_separately", "u1"),
                      ("encode_classes_separately", "u1"),
                      ("minmax", "u1"), ("exit_early", "u1"),
                      ("sigmoid_transform", "u1"), ("init_rng", "<i8"),
                      ("chi_init", "<i8"), ("log_level", "<i8"),
                      ("data_bounds", "ref")])])["opts"]
        enc_name = "legendre_no_norm"
        try:
            enc = _deref(f, o["encoding"])[()]
            enc_name = (enc.decode() if isinstance(enc, bytes) else str(enc))
        except (KeyError, ValueError, TypeError, OSError):
            pass
        try:
            db = tuple(float(x) for x in np.asarray(_deref(f, o["data_bounds"])[()])
                       .reshape(-1)[:2])
        except (KeyError, ValueError, TypeError, OSError):
            db = (0.0, 1.0)
        opts = MPSOptions(
            verbosity=-1, nsweeps=int(o["nsweeps"]),
            chi_max=int(o["chi_max"]), eta=float(o["eta"]), d=int(o["d"]),
            encoding=enc_name, projected_basis=bool(o["projected_basis"]),
            aux_basis_dim=int(o["aux_basis_dim"]), cutoff=float(o["cutoff"]),
            update_iters=int(o["update_iters"]),
            rescale=(bool(o["rescale"]["1"]), bool(o["rescale"]["2"])),
            train_classes_separately=bool(o["train_classes_separately"]),
            encode_classes_separately=bool(o["encode_classes_separately"]),
            minmax=bool(o["minmax"]), exit_early=bool(o["exit_early"]),
            sigmoid_transform=bool(o["sigmoid_transform"]),
            init_rng=int(o["init_rng"]), chi_init=int(o["chi_init"]),
            log_level=int(o["log_level"]), data_bounds=db,
            dtype="float64")

        # ---- tensors -------------------------------------------------------
        mps_ds = _deref(f, _read_members(top, [("mps", "ref")])["mps"])
        vec_ref = mps_ds.fields("data")[()]
        refs = f[vec_ref][()]
        tensors = [_read_itensor(f, r) for r in refs]

        # ---- training data record ------------------------------------------
        td = _read_members(top, [
            ("train_data", [("timeseries", "ref"),
                            ("original_data", "ref")])])["train_data"]
        X_train = np.asarray(_deref(f, td["original_data"]),
                             dtype=np.float64).T
        ps_refs = _deref(f, td["timeseries"])[()]
        y_train = np.empty(len(ps_refs), dtype=np.int64)
        for i, r in enumerate(ps_refs):
            lab = f[r].fields("label")[()]
            if isinstance(lab, (bytes, str, int, np.integer, np.floating)):
                y_train[i] = int(lab)
            else:                       # label stored by reference
                y_train[i] = int(np.asarray(_deref(f, lab)[()]).reshape(-1)[0])

    # ---- convert tensor chain to padded cores ------------------------------
    T = len(tensors)
    chi_max = opts.chi_max
    d = opts.d
    is_site = lambda i: any(t.startswith("Site") for t in i["tags"])
    is_label = lambda i: any("f(x)" in t for t in i["tags"])
    is_link = lambda i: any(t.startswith("Link") for t in i["tags"])

    site_arrays: List[np.ndarray] = []
    label_array = None
    prev_right_id = None
    for t, (arr, inds) in enumerate(tensors):
        ax_site = _axis(inds, is_site)
        ax_label = _axis(inds, is_label)
        links = [k for k in range(len(inds)) if is_link(inds[k])]
        if t == 0:
            ax_left, ax_right = None, links[0]
        elif t == T - 1:
            ax_left = links[0]
            ax_right = None
            if inds[links[0]]["id"] != prev_right_id and len(links) > 1:
                ax_left = links[1]
        else:
            ax_left = next(k for k in links
                           if inds[k]["id"] == prev_right_id)
            ax_right = next(k for k in links if k != ax_left)
        if ax_right is not None:
            prev_right_id = inds[ax_right]["id"]

        order = [a for a in (ax_left, ax_site, ax_right, ax_label)
                 if a is not None]
        full = np.transpose(arr, order)
        if ax_left is None:
            full = full[None]                      # pinch left boundary
        if ax_right is None:
            full = full[:, :, None] if full.ndim == 2 + (ax_label is not None) \
                else full
        if t == T - 1:
            if ax_label is None:
                raise ValueError("expected the class/label index f(x) on "
                                 "the last site of the reference MPS")
            if full.ndim == 3:                     # (left, site, label)
                full = full[:, :, None, :]         # insert chi_r = 1
            label_array = full
        else:
            site_arrays.append(full)

    is_complex = any(np.iscomplexobj(arr) for arr, _ in tensors)
    dtype = np.complex128 if is_complex else np.float64
    if is_complex:
        opts = opts.replace(dtype="complex128")
    cores = np.zeros((T, chi_max, d, chi_max), dtype=dtype)
    for t, A in enumerate(site_arrays):
        if A.shape[0] > chi_max or A.shape[2] > chi_max:
            raise ValueError(f"site {t} bond dims {A.shape} exceed "
                             f"chi_max={chi_max}")
        cores[t, :A.shape[0], :, :A.shape[2]] = A
    center = np.zeros((chi_max, d, chi_max, label_array.shape[3]),
                      dtype=dtype)
    center[:label_array.shape[0], :, :1, :] = label_array

    # re-canonicalize: JLD2-saved models carry no orthogonality guarantee
    # (llim/rlim reset); left-QR sweep restores our invariant (sites <
    # center_pos left-orthogonal) without changing the represented tensor
    for t in range(T - 1):
        A = cores[t]
        M = A.reshape(chi_max * d, chi_max)
        Q, R = np.linalg.qr(M)
        cores[t] = Q.reshape(chi_max, d, chi_max)
        if t + 1 < T - 1:
            cores[t + 1] = np.einsum("ab,bic->aic", R, cores[t + 1])
        else:
            center = np.einsum("ab,bicl->aicl", R, center)

    mps = MPS.from_numpy(cores, center, T - 1, device)

    # ---- rebuild the preprocessing/encoding record --------------------------
    X_train_scaled, norms = transform_train_data(X_train, opts)
    train_ds = encode_dataset(X_train, X_train_scaled, y_train, opts,
                              dtype=dtype, device=device)
    return TrainedMPS(mps, opts, norms, train_ds)


def load_mpstime_jl_eval_results(path: str, *, key: str = "res_baseline"):
    """Parse an ``evaluate`` results baseline saved by the reference
    (JLD2 ``@save ... res_baseline`` — a Vector of per-fold Dicts; written
    by the run in the reference's test/meta_hyperopt.jl:17-55 and compared
    there against fresh ``evaluate`` output, fold indices asserted).

    Returns a list of per-fold dicts with the protocol keys decodable
    outside Julia: ``fold`` (1-based), ``train_inds`` / ``test_inds``
    (1-based index arrays), ``loss`` (array), ``time`` (seconds),
    ``objective`` / ``optimiser`` (strings); Julia-struct-valued entries
    (opts, cache, windows) appear with value ``None`` — their KEYS are the
    protocol surface this loader certifies, their contents are
    Julia-internal.  Used as the cross-implementation oracle for this
    package's :func:`~mpstime_tpu_torch.evaluate` protocol."""
    h5py = _require_h5py()
    import numpy as np
    from h5py import h5s, h5t

    str_dt = h5py.string_dtype()

    def read_pair(f, ds):
        mem = np.dtype([("first", str_dt)])
        out = np.empty((), mem)
        ds.id.read(h5s.ALL, h5s.ALL, out, h5t.py_create(mem))
        k = out["first"][()]
        k = k.decode() if isinstance(k, bytes) else k
        try:
            mem2 = np.dtype([("second", h5py.ref_dtype)])
            out2 = np.empty((), mem2)
            ds.id.read(h5s.ALL, h5s.ALL, out2, h5t.py_create(mem2))
            v = f[out2["second"][()]][()]
            if isinstance(v, bytes):
                v = v.decode()
            elif isinstance(v, np.ndarray) and v.dtype == object:
                v = None                      # vector of Julia objects
            elif isinstance(v, np.void):
                v = None                      # Julia struct
        except (KeyError, ValueError, TypeError, OSError):
            v = None                          # JLD2-internal reference type
        return k, v

    folds = []
    with h5py.File(path, "r") as f:
        for ref in f[key][()]:
            kv_refs = f[f[ref][()]["kvvec"]][()]
            rec = {}
            for r in kv_refs:
                k, v = read_pair(f, f[r])
                rec[k] = v
            folds.append(rec)
    return folds
