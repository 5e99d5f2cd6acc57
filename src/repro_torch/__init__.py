"""repro_torch — the HA-SSA annealer on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that keeps its module names, so each
module's counterpart is found at the same path:

  core.rng, core.ising, core.gset, core.schedule, core.config,
  core.engine, core.ssa, core.memory    — the single-problem annealer
  kernels.bitplane, kernels.ref,
  kernels.ssa_update, kernels.ops       — the spin codec, the plain
                                          versions and the CUDA kernels
  launch.anneal                         — the command-line launcher
  convert                               — numpy hand-over of states/models

The package imports torch and numpy only.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; a CUDA request without a GPU
raises instead of continuing on the CPU.
"""
