"""Spread/interp stages: plain torch ops, tile binning, and the
hand-written CUDA kernels (``csrc/``) behind ``dispatch``."""
