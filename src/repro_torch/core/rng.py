"""Xorshift128 noise lanes: one independent lane per (trial, spin).

Port of the xorshift half of ``repro.core.rng``.  The FPGA's spin gates draw
one noise bit per cycle from a XOR-shift generator; here each (trial, spin)
lane carries a Marsaglia xorshift128 state of four 32-bit words, seeded by
the same SplitMix avalanche as the JAX package so that both produce the same
bits from the same seed.

torch has no shifts on ``uint32`` and its ``>>`` on ``int32`` is
arithmetic, so the lanes are carried as ``int32`` tensors holding the
uint32 bit patterns, and the right shifts go through :func:`_srl`, a
logical shift.  A kernel that takes the lanes reads the same bytes as
``uint32``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "xorshift_init",
    "xorshift_next_bits",
    "xorshift_lanes_ok",
]


def _seed_lane_states(seed: int, idx: np.ndarray, n_total: int) -> np.ndarray:
    """SplitMix avalanche: flat lane indices → (4,) + idx.shape uint32 states."""
    idx = idx.astype(np.uint64)
    states = []
    for word in range(4):
        z = (np.uint64(seed) + np.uint64(0x9E3779B97F4A7C15)
             * (idx + np.uint64(1 + word * n_total)))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        states.append((z & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    st = np.stack(states, axis=0)
    # xorshift forbids the all-zero state; nudge any such lane.
    st[0] = np.where((st == 0).all(axis=0), np.uint32(0x1234567), st[0])
    return st


def xorshift_init(seed: int, lanes: Tuple[int, ...], device=None) -> torch.Tensor:
    """Seed per-lane xorshift128 states: int32 tensor of shape (4,) + lanes."""
    n = int(np.prod(lanes)) if lanes else 1
    st = _seed_lane_states(seed, np.arange(n, dtype=np.uint64), n)
    st = st.reshape((4,) + tuple(lanes)).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(st)).to(device)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 words holding uint32 bit patterns."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def xorshift_next_bits(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Marsaglia xorshift128 step per lane.

    Returns (new_state, noise) with noise int32 in {-1,+1} taken from the
    new output word's most significant bit.
    """
    x, y, z, w = state.unbind(0)
    t = x ^ (x << 11)
    w_new = (w ^ _srl(w, 19)) ^ (t ^ _srl(t, 8))
    new_state = torch.stack([y, z, w, w_new], dim=0)
    noise = torch.where(w_new < 0, 1, -1).to(torch.int32)
    return new_state, noise


def xorshift_lanes_ok(state, axis: int = 0) -> bool:
    """Integrity check on carried lanes: no all-zero lane (xorshift's fixed
    point).  ``axis`` is the 4-word state axis."""
    arr = state.cpu().numpy() if isinstance(state, torch.Tensor) else np.asarray(state)
    if arr.ndim <= axis or arr.shape[axis] != 4:
        return False
    return not bool(np.all(arr == 0, axis=axis).any())
