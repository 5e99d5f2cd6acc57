"""Trajectory-memory models — paper Eq. (5) and Eq. (6) — and the measured
device bytes they are held against (port of ``repro.core.memory``).

SSA stores every spin bitplane of an iteration, M = N · steps · τ bits;
HA-SSA stores only the I0 == I0max plateau, M' = N · τ bits; the ratio is
the number of plateaus (6 for Table II's I0: 1→32, β=1).

The measured half sizes real tensors: :func:`tree_device_bytes` sums the
``nbytes`` of the tensors in a nested structure (an engine state, a noise
buffer), and :func:`live_device_bytes` / :func:`measure_live_bytes` read
the CUDA caching allocator.  They measure the card only: on a host without
one they raise rather than report a CPU number.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Tuple

import torch

from .schedule import n_temp_steps

__all__ = [
    "ssa_bits_per_iteration",
    "hassa_bits_per_iteration",
    "memory_ratio",
    "tree_device_bytes",
    "live_device_bytes",
    "measure_live_bytes",
]


def ssa_bits_per_iteration(n_spins: int, hp) -> int:
    """Eq. (5): all plateaus stored."""
    return n_spins * n_temp_steps(hp.i0_min, hp.i0_max, hp.beta_shift) * hp.tau


def hassa_bits_per_iteration(n_spins: int, hp) -> int:
    """Eq. (6): only the I0max plateau stored."""
    return n_spins * hp.tau


def memory_ratio(hp) -> int:
    """M / M' = number of temperature plateaus (6 for Table II)."""
    return n_temp_steps(hp.i0_min, hp.i0_max, hp.beta_shift)


def tree_device_bytes(tree: Any) -> int:
    """Bytes of the tensors in a nested tuple/list/dict (an engine state, a
    noise buffer); leaves that are not tensors, such as a threefry key
    held on the host, count 0."""
    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_device_bytes(leaf) for leaf in tree)
    return 0


def live_device_bytes(device=None) -> int:
    """Bytes held by live tensors on the CUDA device
    (``torch.cuda.memory_allocated``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("live_device_bytes measures a CUDA device; none is available")
    return torch.cuda.memory_allocated(device)


def measure_live_bytes(build: Callable[[], Any], device=None) -> Tuple[Any, int]:
    """Run ``build()`` and measure the live device bytes it leaves behind.

    The delta of :func:`live_device_bytes` around the call, after a gc pass
    and a device synchronisation on both sides: the tensors the builder
    left resident (its result plus anything it cached) — the measured
    counterpart of the closed forms.  Returns ``(result, delta_bytes)``.
    """
    gc.collect()
    torch.cuda.synchronize(device)
    before = live_device_bytes(device)
    out = build()
    torch.cuda.synchronize(device)
    gc.collect()
    return out, live_device_bytes(device) - before
