"""repro_torch — the HA-SSA annealer on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that keeps its module names, so each
module's counterpart is found at the same path:

  core.rng, core.ising, core.gset, core.schedule, core.config,
  core.engine, core.ssa, core.memory    — the single-problem annealer
  core.ssqa, core.autotune              — SSQA (Trotter-replica rings) and
                                          the hyper-parameter determination
  core.sa, core.pt, core.xla_math       — the SA, PT and PT-SSA baselines
                                          (jax.random's draws, XLA's log)
  problems, core.problems,
  core.placement                        — the problem frontend: QUBO, MIS,
                                          coloring, partition, TSP, GI and
                                          MoE expert placement
  kernels.bitplane, kernels.ref,
  kernels.ssa_update, kernels.ops       — the spin codec, the plain
                                          versions and the CUDA kernels
  serve, ft.faults                      — the annealing service: one-shot
                                          (bucketed, batched) and streamed
                                          (continuous batching), and its
                                          fault injection
  checkpoint.ckpt                       — atomic, keep-last-k checkpoints
                                          (the service's kill/resume)
  launch.anneal                         — the command-line launcher
  benchmarks.serve_stream,
  benchmarks.chaos                      — the open-loop traffic and fault
                                          benchmarks
  benchmarks.other_problems,
  benchmarks.pt_compare, examples       — the family sweep, Table VII and
                                          the runnable drivers
  convert                               — numpy hand-over of states/models

The package imports torch and numpy only.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; a CUDA request without a GPU
raises instead of continuing on the CPU.
"""
import importlib

__all__ = ["SSQAHyperParams", "anneal_ssqa", "resolve_hyperparams"]

# Exported names, imported on first use: importing a numpy-only submodule
# (core.schedule, core.gset) does not load torch or the engine.
_EXPORTS = {"SSQAHyperParams": "core.ssqa", "anneal_ssqa": "core.ssqa",
            "resolve_hyperparams": "core.autotune"}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
