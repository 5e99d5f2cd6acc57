"""repro_torch.kernels — the spin codec, plain versions and CUDA kernels.

``bitplane`` is the ±1 ↔ bit-word codec, ``ref`` holds the plain PyTorch
version of each kernel, ``ssa_update`` the wrappers that launch the CUDA
kernels built from ``csrc/`` by ``_build``, and ``ops`` the public field
entry point.  Nothing here builds or loads a kernel at import time.
"""
