"""Build and load the CUDA kernels (see build.py); nothing is built at
import time."""
