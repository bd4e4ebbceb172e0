"""The port's UCR loader (mpstime_tpu_torch/utils/data_loading.py) held
against the JAX package's on the same files: the arrays equal and the
dtypes the same, the native parser against NumPy, the NumPy fallback, and
the build into the port's own directory."""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from mpstime_tpu.utils import data_loading as jdl
from mpstime_tpu_torch.utils import data_loading as tdl

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"


def _repr(v) -> str:
    return repr(float(v))        # the shortest string that reads back exact


def _write_ucr(path, X, y, fmt, sep=" "):
    with open(path, "w") as f:
        for x, lab in zip(X, y):
            f.write(sep.join([str(lab)] + [fmt(v) for v in x]) + "\n")
    return str(path)


@pytest.fixture
def ecg_files(tmp_path, ecg200):
    Xtr, ytr, *_ = ecg200
    return {
        "g10": _write_ucr(tmp_path / "g10.txt", Xtr, ytr,
                          lambda v: f"{v:.10g}"),
        "repr": _write_ucr(tmp_path / "repr.txt", Xtr, ytr, _repr),
        "comma": _write_ucr(tmp_path / "comma.csv", Xtr, ytr, _repr, ","),
        "tabs": _write_ucr(tmp_path / "tabs.tsv", Xtr, ytr,
                           lambda v: f"{v:.12g}", "\t"),
    }


def _same(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["g10", "repr", "comma", "tabs"])
def test_load_ucr_file_matches_jax(ecg_files, ecg200, kind):
    X, y = tdl.load_ucr_file(ecg_files[kind])
    _same((X, y), jdl.load_ucr_file(ecg_files[kind]))
    assert y.dtype == np.int64 and X.shape == (100, 96)
    np.testing.assert_array_equal(y, ecg200[1])
    if kind in ("repr", "comma"):
        np.testing.assert_array_equal(X, ecg200[0])     # bit for bit


def test_trendysine_matches_jax():
    for split in ("TRAIN", "TEST"):
        path = str(DATA / f"trendysine_{split}.tsv")
        X, y = tdl.load_ucr_file(path)
        _same((X, y), jdl.load_ucr_file(path))
        assert X.shape == (90, 60) and y.dtype == np.int64
        np.testing.assert_array_equal(np.bincount(y), [30, 30, 30])


@pytest.mark.parametrize("text,ydtype", [
    ("1.5 0.5 0.25\n2.5 0.1 0.9\n", np.float64),     # float labels
    ("1,0.5,0.25\n2,0.1,0.9\n", np.int64),           # commas
    ("3 0.5 0.25\n", np.int64),                      # a single row
    ("\n1 1e-3 -2E+2\r\n2 nan inf\n\n", np.int64),   # blank lines, CRLF
])
def test_small_files_match_jax(tmp_path, text, ydtype):
    path = tmp_path / "f.txt"
    path.write_text(text)
    X, y = tdl.load_ucr_file(str(path))
    assert y.dtype == ydtype
    ref = jdl.load_ucr_file(str(path))
    for a, b in zip((X, y), ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_splits_txt_matches_jax(tmp_path):
    paths = []
    for i, name in enumerate(("tr", "va", "te")):
        (tmp_path / f"{name}.txt").write_text(
            f"0 1.0 2.0\n1 3.0 {4.0 + i}\n")
        paths.append(str(tmp_path / f"{name}.txt"))
    got = tdl.load_splits_txt(*paths)
    ref = jdl.load_splits_txt(*paths)
    for g, r in zip(got, ref):
        _same(g, r)


@pytest.mark.parametrize("kind", ["g10", "repr", "comma", "tabs"])
def test_native_matches_numpy(ecg_files, kind):
    assert tdl._get_native() is not None        # g++ is on this machine
    table = tdl._parse_native(ecg_files[kind])
    ref = np.loadtxt(ecg_files[kind],
                     delimiter="," if kind == "comma" else None)
    np.testing.assert_allclose(table, ref, rtol=1e-12, atol=0)


def test_native_refuses_ragged_rows(tmp_path):
    path = tmp_path / "ragged.txt"
    path.write_text("0 1.0 2.0\n1 3.0\n")
    assert tdl._parse_native(str(path)) is None


def _tree(root: Path) -> set:
    """The files under ``root``, less the JAX loader's own library (which
    its tests, run at the same time by another worker, may build)."""
    return {os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if "__pycache__" not in d} - {os.path.abspath(jdl._LIB)}


def test_builds_only_under_the_ports_build_dir(ecg_files, monkeypatch):
    """The parser's library lives in mpstime_tpu_torch/_build/, keyed by
    its source's hash, and loading writes nothing under mpstime_tpu/."""
    monkeypatch.setattr(tdl, "_lib_handle", None)
    monkeypatch.setattr(tdl, "_native_failed", False)
    before = _tree(ROOT / "mpstime_tpu")
    tdl.load_ucr_file(ecg_files["repr"])
    assert tdl._lib_handle is not None
    lib = tdl.library_path()
    assert lib.parent == ROOT / "mpstime_tpu_torch" / "_build"
    assert lib.exists() and lib.name.startswith("libucr_loader_")
    assert tdl._SRC.parent == ROOT / "mpstime_tpu_torch" / "native"
    assert _tree(ROOT / "mpstime_tpu") == before


def test_concurrent_builds(tmp_path):
    """Processes that build the parser at once each load a whole library:
    each writes its own temporary file and renames it into place."""
    code = ("import sys; from pathlib import Path; "
            "from mpstime_tpu_torch.utils import data_loading as d; "
            "d.BUILD_DIR = Path(sys.argv[1]); "
            "X, y = d.load_ucr_file(sys.argv[2]); "
            "assert d._lib_handle is not None; print(X.shape)")
    path = DATA / "trendysine_TEST.tsv"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "b"), str(path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "(90, 60)"
    assert [q.suffix for q in (tmp_path / "b").iterdir()] == [".so"]


def test_numpy_fallback_without_gpp(tmp_path, ecg_files, monkeypatch):
    """Without g++ the loader warns once and parses with NumPy, to the
    same arrays."""
    monkeypatch.setattr(tdl, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tdl, "_lib_handle", None)
    monkeypatch.setattr(tdl, "_native_failed", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.warns(UserWarning, match="falling back to numpy"):
        X, y = tdl.load_ucr_file(ecg_files["comma"])
    assert tdl._get_native() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = tdl.load_ucr_file(ecg_files["g10"])
    _same((X, y), jdl.load_ucr_file(ecg_files["comma"]))
    _same(again, jdl.load_ucr_file(ecg_files["g10"]))
