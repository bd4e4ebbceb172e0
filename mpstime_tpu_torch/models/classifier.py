"""Scikit-learn-style estimator API (counterpart of
``mpstime_tpu/models/classifier.py``; reference src/MLJIntegration/ —
``MPSClassifier <: MMI.Deterministic``, MLJ_integration.jl:2-62).

The reference's MLJ layer mirrors MPSOptions fields with validation ranges
and dispatches to fitMPS/classify.  Here the estimator follows the sklearn
protocol (get_params/set_params/fit/predict/score), making it compatible with
sklearn model-selection tooling without a hard sklearn dependency.

Note: the reference layer is bit-rotted (MLJ_integration.jl:34 destructures
Options as a 3-tuple; MLJ_utils.jl:46 references an undefined name); this
implements the documented intent.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..options import MPSOptions
from ..summary import classify
from ..training.fit import TrainedMPS, fit_mps


class MPSClassifier:
    """MPS time-series classifier with a scikit-learn-style interface.

    Parameters mirror :class:`MPSOptions`; any MPSOptions field can be passed
    as a keyword.  ``device``: where ``fit`` trains and the model lives, the
    card ("cuda", the default) or "cpu".  Complex encodings automatically
    get a complex dtype (reference MLJ_integration.jl:36-45 dtype coupling);
    setting ``train_classes_separately`` couples ``encode_classes_separately``
    unless explicitly overridden.
    """

    def __init__(self, *, nsweeps: int = 5, chi_max: int = 25, d: int = 5,
                 eta: float = 0.01, encoding: str = "legendre_no_norm",
                 device="cuda", **kwargs: Any):
        self.nsweeps = nsweeps
        self.chi_max = chi_max
        self.d = d
        self.eta = eta
        self.encoding = encoding
        self.device = device
        self._extra = dict(kwargs)
        self._validate()
        self.trained_: Optional[TrainedMPS] = None
        self.info_: Optional[dict] = None

    def _validate(self):
        if self.nsweeps < 0:
            raise ValueError("nsweeps must be >= 0")
        if self.chi_max < 1:
            raise ValueError("chi_max must be >= 1")
        if self.d < 1:
            raise ValueError("d must be >= 1")
        if self.eta <= 0:
            raise ValueError("eta must be > 0")
        # eagerly validate option fields/encoding names
        self._make_opts()

    def _make_opts(self) -> MPSOptions:
        extra = dict(self._extra)
        if ("train_classes_separately" in extra
                and "encode_classes_separately" not in extra):
            extra["encode_classes_separately"] = extra["train_classes_separately"]
        return MPSOptions(nsweeps=self.nsweeps, chi_max=self.chi_max,
                          d=self.d, eta=self.eta, encoding=self.encoding,
                          verbosity=extra.pop("verbosity", -5),
                          log_level=extra.pop("log_level", 0), **extra)

    # ---- sklearn protocol -------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        out = {"nsweeps": self.nsweeps, "chi_max": self.chi_max, "d": self.d,
               "eta": self.eta, "encoding": self.encoding,
               "device": self.device}
        out.update(self._extra)
        return out

    def set_params(self, **params) -> "MPSClassifier":
        for k, v in params.items():
            if k in ("nsweeps", "chi_max", "d", "eta", "encoding", "device"):
                setattr(self, k, v)
            else:
                self._extra[k] = v
        self._validate()
        return self

    def fit(self, X: np.ndarray, y: np.ndarray) -> "MPSClassifier":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        self.trained_, self.info_, _ = fit_mps(X, y, opts=self._make_opts(),
                                               device=self.device)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.trained_ is None:
            raise RuntimeError("MPSClassifier is not fitted; call fit() first")
        return classify(self.trained_, np.asarray(X, dtype=np.float64))

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def __repr__(self):
        ps = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"MPSClassifier({ps})"
