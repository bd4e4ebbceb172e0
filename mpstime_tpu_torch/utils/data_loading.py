"""UCR-format dataset loading (counterpart of
``mpstime_tpu/utils/data_loading.py``; reference load_splits_txt,
src/utils.jl:1-22).

Uses the native C++ parser (``mpstime_tpu_torch/native/ucr_loader.cpp``)
when g++ can build it, with a NumPy fallback.  The parser is compiled at
first use into ``mpstime_tpu_torch/_build/``, keyed by a hash of its
source, and written to a temporary file that is renamed into place, so
processes that build it at once never load half a library.  UCR files are
whitespace- or comma-delimited rows of ``label v1 v2 ... vT``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "ucr_loader.cpp"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None
_native_failed = False


def library_path() -> Path:
    """The parser's shared library, keyed by a hash of its source."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libucr_loader_{digest}.so"


def _build() -> Path:
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                            str(_SRC)], check=True, capture_output=True)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib


def _get_native() -> Optional[ctypes.CDLL]:
    """The native parser, built on first use; None (after one warning)
    when it cannot be built or loaded."""
    global _lib_handle, _native_failed
    with _lock:
        if _lib_handle is not None or _native_failed:
            return _lib_handle
        try:
            lib = ctypes.CDLL(str(_build()))
        except (subprocess.CalledProcessError, OSError) as e:
            warnings.warn(f"native UCR loader unavailable ({e}); "
                          "falling back to numpy")
            _native_failed = True
            return None
        lib.ucr_parse.restype = ctypes.c_int
        lib.ucr_parse.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        _lib_handle = lib
        return lib


def _parse_native(path: str) -> Optional[np.ndarray]:
    """The file as a [rows, 1 + T] float64 table, or None when the native
    parser is unavailable or refuses the file."""
    lib = _get_native()
    if lib is None:
        return None
    nrows = ctypes.c_int64()
    ncols = ctypes.c_int64()
    rc = lib.ucr_parse(path.encode(), None, 0, ctypes.byref(nrows),
                       ctypes.byref(ncols))
    if rc != 0:
        return None
    out = np.empty((nrows.value, ncols.value), dtype=np.float64)
    rc = lib.ucr_parse(path.encode(),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       out.size, ctypes.byref(nrows), ctypes.byref(ncols))
    if rc != 0:
        return None
    return out


def load_ucr_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one UCR-format file -> (X [N, T], y [N]).

    Labels are the first column, cast to int64 when integral."""
    path = str(path)
    table = _parse_native(path)
    if table is None:
        with open(path) as f:
            first = f.readline()
        delim = "," if "," in first else None
        table = np.loadtxt(path, delimiter=delim)
        if table.ndim == 1:
            table = table[None, :]
    y = table[:, 0]
    X = table[:, 1:]
    if np.allclose(y, np.round(y)):
        y = np.round(y).astype(np.int64)
    return X, y


def load_splits_txt(train_path: str, val_path: str, test_path: str):
    """Load train/val/test UCR files (reference load_splits_txt,
    utils.jl:1-22).  Returns ((X_train, y_train), (X_val, y_val),
    (X_test, y_test))."""
    return (load_ucr_file(train_path), load_ucr_file(val_path),
            load_ucr_file(test_path))
