"""Build and load the port's CUDA kernels.

The sources under ``mpstime_tpu_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), loaded with ``ctypes``: one ``nvcc -c`` per ``.cu`` source,
all started together, then one link.  The library is built at first use
into ``mpstime_tpu_torch/_build/``, keyed by a hash of the sources and the
flags, so a fresh checkout builds it on its first CUDA call.  ``build_log``
keeps the compilers' output (``-Xptxas -v``: registers, shared memory and
spills of each kernel).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Seconds the last build took (0.0 when the library was already built).
last_build_seconds = 0.0
#: The compilers' output of the last build ("" when nothing was built).
build_log = ""


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch found."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def library_path() -> Path:
    return BUILD_DIR / f"libmpstime_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the .cu sources into the keyed shared library unless it is
    there; returns its path.  Raises RuntimeError with nvcc's output when
    the build fails."""
    global last_build_seconds, build_log
    out = library_path()
    if out.exists():
        last_build_seconds, build_log = 0.0, ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            objs.append(str(Path(tmp) / (src.stem + ".o")))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [proc.communicate()[0] for _, proc in procs]   # wait for all
        for (cmd, proc), text in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{text}")
        lib = str(Path(tmp) / "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(lib, out)      # atomic: a concurrent build never sees half
    last_build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its C signatures
    declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # each complex launcher takes its real twin's argument list; K12c
        # and the cluster K12m and K12mc take K12m's and the cluster size,
        # K12cr K12mc's, the Jacobi round count and the cluster size, and
        # the cluster K1a, K1c-grad, K1, K1c, K1b, K1c-update, K2, K2c,
        # K2-split and K2c-split their one-block launchers' and the cluster
        # size, and the by-part K2 and K2c the parts to run before it; the
        # row-tile K2-env and K2c-env their one-block launchers', the rows
        # a block and the staging flag, the grid K1-tail and K1c-tail
        # theirs and the blocks
        for ws in ("mpst_k12_workspace_floats", "mpst_c_workspace_floats"):
            getattr(lib, ws).argtypes = [i, i, i, i]
            getattr(lib, ws).restype = ctypes.c_long
        for names, argtypes in (
                (("mpst_k12m_launch", "mpst_k12mc_launch"),
                 [p] * 17 + [i] * 10 + [f] * 3 + [p]),
                (("mpst_k1_launch", "mpst_k1c_launch"),
                 [p] * 13 + [i] * 10 + [f] + [p]),
                (("mpst_k2_launch", "mpst_k2c_launch"),
                 [p] * 10 + [i] * 5 + [f] * 2 + [p]),
                (("mpst_k2_cluster_launch", "mpst_k2c_cluster_launch"),
                 [p] * 10 + [i] * 5 + [f] * 2 + [i, p]),
                (("mpst_k2_cluster_parts_launch",
                  "mpst_k2c_cluster_parts_launch"),
                 [p] * 10 + [i] * 5 + [f] * 2 + [i, i, p]),
                (("mpst_k12c_launch", "mpst_k12m_cluster_launch",
                  "mpst_k12mc_cluster_launch"), [p] * 17 + [i] * 10
                 + [f] * 3 + [i, p]),
                (("mpst_k12cr_launch",), [p] * 17 + [i] * 10 + [f] * 3
                 + [i, i, p]),
                (("mpst_k1a_launch", "mpst_k1c_grad_launch"),
                 [p] * 11 + [i] * 6 + [p]),
                (("mpst_k1a_cluster_launch", "mpst_k1c_grad_cluster_launch"),
                 [p] * 11 + [i] * 7 + [p]),
                (("mpst_k1_cluster_launch", "mpst_k1c_cluster_launch"),
                 [p] * 13 + [i] * 10 + [f] + [i, p]),
                (("mpst_k1b_launch", "mpst_k1c_update_launch"),
                 [p] * 7 + [i] * 8 + [f, p]),
                (("mpst_k1b_cluster_launch",
                  "mpst_k1c_update_cluster_launch"), [p] * 7 + [i] * 8
                 + [f, i, p]),
                (("mpst_k1_tail_launch", "mpst_k1c_tail_launch"),
                 [p] * 4 + [i] * 6 + [p]),
                (("mpst_k2_split_launch", "mpst_k2c_split_launch"),
                 [p] * 6 + [i] * 4 + [f] * 2 + [p]),
                (("mpst_k2_split_cluster_launch",
                  "mpst_k2c_split_cluster_launch"),
                 [p] * 6 + [i] * 4 + [f] * 2 + [i, p]),
                (("mpst_k2_env_launch", "mpst_k2c_env_launch"),
                 [p] * 7 + [i] * 4 + [p]),
                (("mpst_k2_env_rows_launch", "mpst_k2c_env_rows_launch"),
                 [p] * 7 + [i] * 6 + [p]),
                (("mpst_k1_tail_grid_launch", "mpst_k1c_tail_grid_launch"),
                 [p] * 4 + [i] * 7 + [p])):
            for name in names:
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = i
        for name in ("mpst_cluster_occupancy", "mpst_c_cluster_occupancy"):
            getattr(lib, name).argtypes = [i, i, i, ctypes.POINTER(i)]
            getattr(lib, name).restype = i
        for name in ("mpst_grid_occupancy", "mpst_c_grid_occupancy"):
            getattr(lib, name).argtypes = [i, ctypes.POINTER(i)]
            getattr(lib, name).restype = i
        lib.mpst_error_string.argtypes = [i]
        lib.mpst_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
