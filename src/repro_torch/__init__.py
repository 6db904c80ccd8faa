"""PyTorch/CUDA port of the D-Rank reproduction (the JAX package ``repro``
is its reference). Module layout and names mirror ``repro``; the kernels
are hand-written CUDA for Hopper under ``csrc/``, each with its plain
PyTorch version in ``kernels/ref.py``."""
