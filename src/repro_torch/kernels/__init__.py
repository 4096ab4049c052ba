"""Hand-written CUDA kernels and their plain PyTorch versions.

Each family has ``kernel.py`` (the ctypes-bound CUDA wrapper with its
launch counter), ``ref.py`` (the plain version) and ``ops.py`` (host
packers, numpy mirrors and numpy-in/numpy-out dispatch).
"""
