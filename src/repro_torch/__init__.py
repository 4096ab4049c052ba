"""repro_torch: the PyTorch + CUDA port of the ``repro`` package.

Boolean-AND and ranked BM25 top-k serving over the optimally partitioned
VByte index, with the NextGEQ, BM25 scoring and Block-Max pivot kernels
hand-written in CUDA C++ for Hopper (``csrc/``).  The
package imports ``torch`` and numpy only -- never ``jax`` and nothing of
``repro``, which stays beside it as the reference the port is held to.
Its entry points run on the card unless the caller passes
``device="cpu"``.
"""
