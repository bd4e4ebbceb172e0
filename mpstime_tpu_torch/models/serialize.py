"""TrainedMPS save/load (counterpart of ``mpstime_tpu/models/serialize.py``;
replaces the reference's JLD2 serialization, options.jl:8, test/save_load.jl).

Format: one ``.npz`` holding the MPS tensors, the training-data record, the
fitted transform statistics and the options as JSON, the JAX package's
format (``format_version`` 1) key for key, so a file that either package
saves loads in the other.  Custom encodings hold callables and cannot be
serialized: as in the reference, they are re-supplied on load.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..encodings import EncodedDataset
from ..options import MPSOptions
from ..training.fit import TrainedMPS
from ..utils.preprocessing import TransformNorms
from .mps import MPS


def _flatten_enc_args(enc_args, prefix: str, out: dict, meta: dict) -> None:
    if enc_args is None:
        meta[prefix] = None
        return
    if isinstance(enc_args, list):
        meta[prefix] = {"type": "list", "n": len(enc_args)}
        for i, a in enumerate(enc_args):
            _flatten_enc_args(a, f"{prefix}.{i}", out, meta)
        return
    if isinstance(enc_args, dict):
        meta[prefix] = {"type": "dict", "keys": sorted(enc_args.keys())}
        for k in sorted(enc_args.keys()):
            out[f"enc__{prefix}.{k}"] = np.asarray(enc_args[k])
        return
    raise TypeError(f"cannot serialize enc_args of type {type(enc_args)}")


def _unflatten_enc_args(prefix: str, data, meta: dict):
    spec = meta[prefix]
    if spec is None:
        return None
    if spec["type"] == "list":
        return [_unflatten_enc_args(f"{prefix}.{i}", data, meta)
                for i in range(spec["n"])]
    out = {}
    for k in spec["keys"]:
        arr = data[f"enc__{prefix}.{k}"]
        out[k] = arr.item() if arr.shape == () else arr
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_mps(path: str, trained: TrainedMPS) -> None:
    """Serialize a TrainedMPS to ``path`` (.npz).  Custom encodings: their
    enc_args must be plain arrays; the encoding itself is re-supplied at
    load time."""
    tr = trained.train_data
    arrays = {
        "cores": _host(trained.mps.cores),
        "center": _host(trained.mps.center),
        "X_enc": _host(tr.X_enc),
        "y_idx": tr.y_idx,
        "labels": tr.labels,
        "X_orig": tr.X_orig,
        "X_scaled": tr.X_scaled,
        "class_distribution": tr.class_distribution,
    }
    meta: dict = {
        "format_version": 1,
        "center_pos": trained.mps.center_pos,
        "opts": trained.opts.to_dict(),
        "norms": trained.norms.to_dict(),
        "encode_separately": tr.encode_separately,
        "has_custom_encoding": trained.custom_encoding is not None,
        "enc_meta": {},
    }
    _flatten_enc_args(tr.enc_args, "root", arrays, meta["enc_meta"])
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_mps(path: str, custom_encoding=None, device="cuda") -> TrainedMPS:
    """Load a TrainedMPS saved by :func:`save_mps` (of either package), with
    the cores, center and encoded training set on ``device``.  A model
    trained with a custom encoding needs it re-supplied here."""
    with np.load(path, allow_pickle=False) as f:
        data = {k: f[k] for k in f.files}
    meta = json.loads(bytes(data["meta_json"]).decode("utf-8"))
    if meta.get("format_version") != 1:
        raise ValueError(f"unknown save format {meta.get('format_version')}")
    opts = MPSOptions.from_dict(meta["opts"])
    norms = TransformNorms.from_dict(meta["norms"])
    if meta["has_custom_encoding"] and custom_encoding is None:
        raise ValueError("This MPS was trained with a custom encoding; pass "
                         "it to load_mps(custom_encoding=...)")
    enc_args = _unflatten_enc_args("root", data, meta["enc_meta"])

    mps = MPS.from_numpy(data["cores"], data["center"],
                         int(meta["center_pos"]), device)
    train = EncodedDataset(
        X_enc=torch.from_numpy(data["X_enc"]).to(device),
        y_idx=data["y_idx"], labels=data["labels"],
        X_orig=data["X_orig"], X_scaled=data["X_scaled"],
        class_distribution=data["class_distribution"],
        enc_args=enc_args, encode_separately=bool(meta["encode_separately"]))
    return TrainedMPS(mps, opts, norms, train, custom_encoding)


def trained_mps_equal(a: TrainedMPS, b: TrainedMPS, atol: float = 0.0) -> bool:
    """Equality check for round trips (reference ==/isapprox on TrainedMPS,
    Structs/operations.jl:4-36), on host copies, so models on different
    devices compare."""
    if a.opts != b.opts or a.mps.center_pos != b.mps.center_pos:
        return False
    pairs = [
        (_host(a.mps.cores), _host(b.mps.cores)),
        (_host(a.mps.center), _host(b.mps.center)),
        (_host(a.train_data.X_enc), _host(b.train_data.X_enc)),
        (a.train_data.X_orig, b.train_data.X_orig),
    ]
    for x, y in pairs:
        if x.shape != y.shape:
            return False
        if atol == 0.0:
            if not np.array_equal(x, y):
                return False
        elif not np.allclose(x, y, atol=atol):
            return False
    return (np.array_equal(a.train_data.y_idx, b.train_data.y_idx)
            and np.array_equal(a.train_data.labels, b.train_data.labels)
            and a.norms.to_dict() == b.norms.to_dict())
