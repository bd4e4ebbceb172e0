"""Build and load the port's CUDA kernels.

The sources under ``mpstime_tpu_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), loaded with ``ctypes``.  The library is built at first use
into ``mpstime_tpu_torch/_build/``, keyed by a hash of the sources and the
flags, so a fresh checkout builds it on its first CUDA call.  Nothing here
runs at import time.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Seconds the last build took (0.0 when the library was already built).
last_build_seconds = 0.0


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
    global last_build_seconds
    out = library_path()
    if out.exists():
        last_build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent build never sees half
    last_build_seconds = time.perf_counter() - t0
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
        lib.mpst_k12_workspace_floats.argtypes = [i, i, i, i]
        lib.mpst_k12_workspace_floats.restype = ctypes.c_long
        lib.mpst_k12m_launch.argtypes = [p] * 17 + [i] * 10 + [f] * 3 + [p]
        lib.mpst_k12m_launch.restype = i
        lib.mpst_error_string.argtypes = [i]
        lib.mpst_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
