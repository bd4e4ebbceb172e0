"""mpstime_tpu_torch: the PyTorch + CUDA port of mpstime_tpu.

Time-series classification with label-indexed Matrix Product States
(MPSTime.jl's method), trained by DMRG-style two-site sweeps, with
probabilistic imputation, entanglement analysis, missing-data
simulation, serialization (and import of models MPSTime.jl trained), and
cross-validated hyperparameter tuning on the trained model's device.  This
package
keeps the JAX package's module paths, public names and array layouts; the
JAX package stays the reference each module is held against.  The training
sweep's bond steps run as hand-written CUDA kernels on an NVIDIA GPU, where
the entry points run unless the caller asks for the CPU (``device="cpu"``),
and as their plain PyTorch versions on the CPU.  Importing the package
imports neither JAX nor a compiler.
"""

from .options import MPSOptions, print_opts
from .encodings import (EncodingSpec, get_encoding, function_basis,
                        encoding_range, EncodedDataset, encode_dataset,
                        stoudenmire, fourier, legendre, legendre_no_norm,
                        sahand, uniform, sahand_legendre, histogram_split,
                        uniform_split)
from .models.mps import (MPS, SingleMPS, random_mps, contract_batch,
                         contract_batch_scaled, expand_label_index)
from .training.fit import fit_mps, fit_mps_batch, TrainedMPS
from .summary import (classify, classify_encoded, classify_overlap,
                      get_training_summary, sweep_summary, KL_div)
from .utils.preprocessing import (TransformNorms, transform_data,
                                  transform_train_data, transform_test_data,
                                  invert_test_transform)
from .imputation import (ImputationProblem, init_imputation_problem,
                         mps_impute, MPS_impute, get_cdfs, kNN_impute,
                         sample_trajectories)
from .simulation import mcar, mar, mnar, trendy_sine, state_space
from .analysis import (von_neumann_entropy, bipartite_spectrum,
                       single_site_entropy, single_site_spectrum,
                       see_variation, one_site_rdm, rho_correct)
from .hyperopt import (tune, evaluate, MPSRandomSearch, ScipySolver,
                       MisclassificationRate,
                       BalancedMisclassificationRate, ImputationLoss,
                       eval_loss, make_stratified_cvfolds, make_windows)
from .hyperopt.losses import is_omp_threading
from .models.serialize import save_mps, load_mps, trained_mps_equal
from .models.itensor_import import load_mpstime_jl
from .models.classifier import MPSClassifier
from .parallel import DeviceFarm, ProcessFarm

__version__ = "0.1.0"

__all__ = [
    "MPSOptions", "print_opts",
    "EncodingSpec", "get_encoding", "function_basis", "encoding_range",
    "EncodedDataset", "encode_dataset",
    "stoudenmire", "fourier", "legendre", "legendre_no_norm", "sahand",
    "uniform", "sahand_legendre", "histogram_split", "uniform_split",
    "is_omp_threading",
    "MPS", "SingleMPS", "random_mps", "contract_batch",
    "contract_batch_scaled", "expand_label_index",
    "fit_mps", "fit_mps_batch", "TrainedMPS", "classify", "classify_encoded",
    "classify_overlap", "get_training_summary", "sweep_summary", "KL_div",
    "TransformNorms", "transform_data", "transform_train_data",
    "transform_test_data", "invert_test_transform",
    "ImputationProblem", "init_imputation_problem", "mps_impute",
    "MPS_impute", "get_cdfs", "kNN_impute", "sample_trajectories",
    "mcar", "mar", "mnar", "trendy_sine", "state_space",
    "von_neumann_entropy", "bipartite_spectrum", "single_site_entropy",
    "single_site_spectrum", "see_variation", "one_site_rdm", "rho_correct",
    "tune", "evaluate", "MPSRandomSearch", "ScipySolver", "MisclassificationRate",
    "load_mpstime_jl",
    "BalancedMisclassificationRate", "ImputationLoss", "eval_loss",
    "make_stratified_cvfolds", "make_windows",
    "save_mps", "load_mps", "trained_mps_equal",
    "MPSClassifier",
    "DeviceFarm", "ProcessFarm",
]
