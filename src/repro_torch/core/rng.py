"""Noise sources of the p-bits: xorshift128 lanes and threefry draws.

Port of ``repro.core.rng``.

**xorshift128** (the production source): one independent lane per (trial,
spin).  The FPGA's spin gates draw
one noise bit per cycle from a XOR-shift generator; here each (trial, spin)
lane carries a Marsaglia xorshift128 state of four 32-bit words, seeded by
the same SplitMix avalanche as the JAX package so that both produce the same
bits from the same seed.

torch has no shifts on ``uint32`` and its ``>>`` on ``int32`` is
arithmetic, so the lanes are carried as ``int32`` tensors holding the
uint32 bit patterns, and the right shifts go through :func:`_srl`, a
logical shift.  A kernel that takes the lanes reads the same bytes as
``uint32``.

**threefry** (the JAX package's default for ``anneal()``): the noise of
``jax.random`` — a key chain on the host, one split per cycle, and a
counter-based draw on the device.  It reproduces ``jax.random`` as the
JAX package runs it: jax >= 0.5 with ``jax_threefry_partitionable=True``
(the default since 0.5) and 64-bit types off.  jax < 0.5 defaulted to the
non-partitionable scheme, whose counters and splits differ, so its draws
are not these.  In the partitionable scheme

* a draw of ``shape`` hashes the flat element index, split into
  (hi, lo) 32-bit counters, under the key: bits = b1 ^ b2 of
  ``threefry2x32(key, (hi, lo))``;
* ``split(key)`` is that draw of shape (2,): the output pairs are the new
  key and the subkey;
* ``bernoulli(sub, 0.5)`` is true — noise +1 — exactly when bit 31 of the
  bits is 0.

The words are carried as ``int64`` tensors masked to 32 bits (torch has no
logical shift or unsigned compare on 32-bit words); keys are pairs of
Python ints.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "Xorshift128",
    "xorshift_init",
    "xorshift_next_bits",
    "xorshift_lanes_ok",
    "xorshift_noise_cycles",
    "threefry2x32",
    "threefry_key",
    "threefry_split",
    "threefry_noise",
    "threefry_noise_cycles",
    "PRNGKey",
    "split",
    "split_keys",
    "random_bits",
    "uniform",
    "randint",
    "bernoulli",
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


def xorshift_noise_cycles(state: torch.Tensor, n_cycles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_cycles`` successive steps of the lanes: (state after them,
    (C,) + lanes int8 ±1 noise), the pregenerated noise of a plateau."""
    draws = []
    for _ in range(int(n_cycles)):
        state, r = xorshift_next_bits(state)
        draws.append(r.to(torch.int8))
    return state, torch.stack(draws)


class Xorshift128:
    """Object wrapper over the functional lanes: ``next_bits()`` steps every
    lane once and returns its ±1 int32 noise."""

    def __init__(self, seed: int, lanes: Tuple[int, ...], device=None):
        self.state = xorshift_init(seed, lanes, device)

    def next_bits(self) -> torch.Tensor:
        self.state, bits = xorshift_next_bits(self.state)
        return bits


def xorshift_lanes_ok(state, axis: int = 0) -> bool:
    """Integrity check on carried lanes: no all-zero lane (xorshift's fixed
    point).  ``axis`` is the 4-word state axis."""
    arr = state.cpu().numpy() if isinstance(state, torch.Tensor) else np.asarray(state)
    if arr.ndim <= axis or arr.shape[axis] != 4:
        return False
    return not bool(np.all(arr == 0, axis=axis).any())


# ---------------------------------------------------------------------------
# threefry2x32 and the jax.random noise built on it
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as ``jax.random`` computes it.

    Works on Python ints or ``int64`` tensors holding 32-bit words (keys
    and counters broadcast against each other); returns the two output
    words, masked to 32 bits.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed is taken
    as a 32-bit integer, so the high word is 0 and the low word is
    ``seed mod 2**32``."""
    return (0, int(seed) & _M32)


def threefry_split(key: Key) -> Tuple[Key, Key]:
    """``key, sub = jax.random.split(key)`` on the host."""
    k0, k1 = key
    a0, a1 = threefry2x32(k0, k1, 0, 0)
    b0, b1 = threefry2x32(k0, k1, 0, 1)
    return (a0, a1), (b0, b1)


def _draw_sign(k0, k1, n: int, device) -> torch.Tensor:
    """bit 31 of (b1 ^ b2) for flat counters 0..n-1 under keys (k0, k1),
    which may be (C, 1) tensors; returns True where the noise is +1."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    hi = lo >> 32
    b0, b1 = threefry2x32(k0, k1, hi, lo & _M32)
    return ((b0 ^ b1) >> 31) == 0


def threefry_noise(key: Key, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """±1 int32 noise of ``shape`` from one key — the port of
    ``repro.core.rng.threefry_noise``."""
    n = int(np.prod(shape)) if shape else 1
    plus = _draw_sign(key[0], key[1], n, device)
    return torch.where(plus, 1, -1).to(torch.int32).reshape(shape)


# Elements per vectorised draw: bounds the int64 temporaries of a
# pregenerated plateau (about ten live tensors of 8 B per element).
_DRAW_CHUNK = 1 << 22


def threefry_noise_cycles(key: Key, n_cycles: int, shape: Tuple[int, ...],
                          device=None) -> Tuple[Key, torch.Tensor]:
    """``n_cycles`` successive per-cycle draws in one pass.

    The key chain (one split per cycle) runs on the host; the draws run on
    ``device`` with the cycles' subkeys broadcast, in chunks of whole
    cycles.  Returns (key after the last split, (C,) + shape int8 ±1
    noise) — equal to C calls of ``key, sub = split(key);
    threefry_noise(sub, shape)``.
    """
    subs = []
    for _ in range(int(n_cycles)):
        key, sub = threefry_split(key)
        subs.append(sub)
    n = int(np.prod(shape)) if shape else 1
    out = torch.empty((len(subs), n), dtype=torch.int8, device=device)
    per = max(1, _DRAW_CHUNK // max(n, 1))
    for c0 in range(0, len(subs), per):
        ks = torch.tensor(subs[c0:c0 + per], dtype=torch.int64).to(device)
        plus = _draw_sign(ks[:, 0:1], ks[:, 1:2], n, device)
        out[c0:c0 + per] = torch.where(plus, 1, -1).to(torch.int8)
    return key, out.reshape((len(subs),) + tuple(shape))


# ---------------------------------------------------------------------------
# The rest of jax.random that SA and PT draw, with partitionable threefry.
#
# A batch of keys is an int64 array or tensor of shape (..., 2) holding the
# two 32-bit words; a single key is a pair of Python ints.  ``split`` and the
# draws hash the flat index i of their output under the key, with counters
# (i >> 32, i & 0xFFFFFFFF); a draw's 32-bit word is b1 ^ b2.
# ---------------------------------------------------------------------------
def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` (64-bit types off)."""
    return threefry_key(seed)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` on the host: ``num`` keys (pairs of
    Python ints); key i is ``threefry2x32(key, (0, i))``."""
    k0, k1 = key
    return [threefry2x32(k0, k1, i >> 32, i & _M32) for i in range(int(num))]


def split_keys(keys, num: int):
    """``jax.random.split`` of every key of a (..., 2) int64 batch at once:
    a (..., num, 2) batch of the same type (numpy array or tensor)."""
    is_t = isinstance(keys, torch.Tensor)
    k0, k1 = keys[..., 0:1], keys[..., 1:2]
    if is_t:
        i = torch.arange(int(num), dtype=torch.int64, device=keys.device)
    else:
        keys = np.asarray(keys, np.int64)
        k0, k1 = keys[..., 0:1], keys[..., 1:2]
        i = np.arange(int(num), dtype=np.int64)
    a, b = threefry2x32(k0, k1, i >> 32, i & _M32)
    return torch.stack([a, b], dim=-1) if is_t else np.stack([a, b], axis=-1)


def _key_words(key, device):
    """(k0, k1) of a key or a (..., 2) key batch, as int64 tensors shaped
    (..., 1) to broadcast over a draw's flat index (Python ints for a key)."""
    if isinstance(key, tuple):
        return key
    keys = torch.as_tensor(np.asarray(key, np.int64) if not isinstance(key, torch.Tensor)
                           else key, dtype=torch.int64, device=device)
    return keys[..., 0:1], keys[..., 1:2]


def random_bits(key, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 tensors holding the
    words; a key batch of shape (..., 2) gives (...) + shape."""
    n = int(np.prod(shape)) if shape else 1
    k0, k1 = _key_words(key, device)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k0, k1, lo >> 32, lo & _M32)
    bits = b0 ^ b1
    return bits.reshape(tuple(bits.shape[:-1]) + tuple(shape))


def uniform(key, shape: Tuple[int, ...], minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to [minval, maxval), then
    ``max(minval, ·)``."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    lo_d = lo.to(f.device)
    return torch.maximum(lo_d, f * (hi - lo).to(f.device) + lo_d)


def randint(key, shape: Tuple[int, ...], minval, maxval, device=None) -> torch.Tensor:
    """``jax.random.randint`` (int32): two draws of 32 bits under the key's
    two-way split, combined as ``(hi % span) * (2^32 % span) + lo % span``
    in wrapping uint32, mod span.  ``maxval`` (and ``minval``) may be a
    tensor broadcasting against the draw: the service's per-problem live
    spin counts."""
    if isinstance(key, tuple):
        k1, k2 = split(key)
    else:
        ks = split_keys(key, 2)
        k1, k2 = ks[..., 0, :], ks[..., 1, :]
    hi_bits = random_bits(k1, shape, device)
    lo_bits = random_bits(k2, shape, device)
    lo = torch.as_tensor(minval, dtype=torch.int64, device=hi_bits.device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=hi_bits.device)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _M32)
    mult = ((65536 % span) * (65536 % span) & _M32) % span
    off = (((hi_bits % span) * mult & _M32) + lo_bits % span) & _M32
    return (lo + off % span).to(torch.int32)


def bernoulli(key, p: float, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in float32."""
    return uniform(key, shape, device=device) < torch.tensor(p, dtype=torch.float32)
