from .vis_encodings import plot_encoding
from .plots import plot_conf_mat, plot_training_summary

__all__ = ["plot_encoding", "plot_conf_mat", "plot_training_summary"]
