"""Trajectory-memory models — paper Eq. (5) and Eq. (6) — and the measured
device bytes they are held against (port of ``repro.core.memory``).

SSA stores every spin bitplane of an iteration, M = N · steps · τ bits;
HA-SSA stores only the I0 == I0max plateau, M' = N · τ bits; the ratio is
the number of plateaus (6 for Table II's I0: 1→32, β=1).  The service pads
an instance to its power-of-two shape bucket, so each stored bitplane
carries ``bucket(N) - N`` dead bits a cycle: the ``padding_overhead_*``
models count them.

The measured half sizes real tensors: :func:`tree_device_bytes` sums the
``nbytes`` of the tensors in a nested structure (an engine state, a noise
buffer), :func:`per_device_bytes` / :func:`max_device_bytes` split it by
rank under spin sharding, and :func:`live_device_bytes` /
:func:`measure_live_bytes` read the CUDA caching allocator.  The last two
measure the card only: on a host without one they raise rather than report
a CPU number.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Tuple

import numpy as np
import torch

from .engine import bucket_n
from .schedule import n_temp_steps

__all__ = [
    "ssa_bits_per_iteration",
    "hassa_bits_per_iteration",
    "memory_ratio",
    "bits_per_trial",
    "padding_overhead_bits_per_iteration",
    "padding_overhead_fraction",
    "tree_device_bytes",
    "per_device_bytes",
    "max_device_bytes",
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


def bits_per_trial(n_spins: int, hp, hardware_aware: bool = True) -> int:
    """Eq. (6) (``hardware_aware``) or Eq. (5) bits over a trial's m_shot
    iterations."""
    per_iter = (hassa_bits_per_iteration(n_spins, hp) if hardware_aware
                else ssa_bits_per_iteration(n_spins, hp))
    return per_iter * hp.m_shot


def padding_overhead_bits_per_iteration(n_spins: int, hp, min_bucket: int = 64,
                                        hardware_aware: bool = True) -> int:
    """Dead bits stored per iteration when N is padded to its shape bucket:
    ``(bucket(N) - N) × stored cycles``."""
    pad = bucket_n(n_spins, min_bucket) - n_spins
    stored = hp.tau if hardware_aware else memory_ratio(hp) * hp.tau
    return pad * stored


def padding_overhead_fraction(n_spins: int, min_bucket: int = 64) -> float:
    """Fraction of each stored bitplane spent on pad lanes: 1 - N/bucket(N)."""
    return 1.0 - n_spins / bucket_n(n_spins, min_bucket)


def _leaves(tree):
    """The tensor and numpy leaves of a nested tuple/list/dict."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from _leaves(leaf)
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree


def tree_device_bytes(tree: Any) -> int:
    """Bytes of the tensors in a nested tuple/list/dict (an engine state, a
    noise buffer); leaves that are not tensors, such as a threefry key
    held on the host, count 0."""
    return sum(leaf.nbytes for leaf in _leaves(tree) if isinstance(leaf, torch.Tensor))


def per_device_bytes(tree: Any, mesh=None) -> dict:
    """Resident bytes by device: what decides whether a spin-sharded
    instance fits is what each rank holds, not the global footprint.

    The tensors of ``tree`` count on their device; numpy leaves count under
    ``'host'``.  With a
    :class:`~repro_torch.sharding.SpinMesh` the tree is this rank's
    shards: the keys are ``'<device type>:<rank>'``, each rank's bytes are
    all-gathered (every rank returns the same dict), and ``'host'`` sums the
    ranks' host bytes.
    """
    host = 0
    dev: dict = {}
    for leaf in _leaves(tree):
        if isinstance(leaf, np.ndarray):
            host += int(leaf.nbytes)
        else:
            key = f"{leaf.device.type}:{leaf.device.index or 0}"
            dev[key] = dev.get(key, 0) + int(leaf.nbytes)
    if mesh is not None:
        from ..sharding import all_gather_last

        mine = torch.tensor([sum(dev.values()), host], dtype=torch.int64, device=mesh.device)
        every = all_gather_last(mesh, mine).reshape(mesh.size, 2).tolist()
        dev = {f"{mesh.device.type}:{r}": b for r, (b, _) in enumerate(every)}
        host = sum(h for _, h in every)
    if host:
        dev["host"] = host
    return dev


def max_device_bytes(tree: Any, mesh=None) -> int:
    """The busiest device's resident bytes (0 when nothing is held): under
    spin sharding, what falls about linearly with the rank count."""
    per = per_device_bytes(tree, mesh)
    return max(per.values()) if per else 0


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
