"""Bitplane codec: ±1 spins and integer couplings as 32-bit words.

Port of ``repro.kernels.bitplane``.  A spin vector ``m ∈ {-1,+1}^N``
becomes ``ceil(N/32)`` words, bit ``k`` of word ``w`` holding the sign of
spin ``n = 32·w + k`` (1 ⇔ +1); tail bits at index ≥ N are 0.  Words are
carried as ``int32`` tensors holding the uint32 bit patterns (torch has no
shifts on ``uint32``); ``.numpy().view(np.uint32)`` gives the JAX
package's words.

The coupling half packs an integer J as a sign plane plus magnitude
bitplanes (:class:`PackedJ`), the operand of the XNOR-popcount field

    sum_j sign_ij * m_j  =  2 * popcount(XNOR(m_words, sign_words) & mask)
                            - popcount(mask)

(``repro_torch.core.ising.local_fields_popcount`` and kernel K2).  The
packing runs on the host in numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "packed_words",
    "packed_nbytes",
    "pack_spins",
    "unpack_spins",
    "popcount_u32",
    "PackedJ",
    "pack_couplings",
    "pack_couplings_from_adjacency",
    "adjacency_weight_bits",
    "packed_j_nbytes",
]

_SHIFTS_NP = np.arange(32, dtype=np.uint32)


def packed_words(n: int) -> int:
    """Words needed for an N-spin bitplane: ceil(N/32)."""
    return (int(n) + 31) // 32


def packed_nbytes(n: int) -> int:
    """Bytes of one packed N-spin plane."""
    return 4 * packed_words(n)


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def pack_spins(m: torch.Tensor) -> torch.Tensor:
    """Pack ±1 spins [..., N] into int32 words [..., ceil(N/32)]."""
    n = m.shape[-1]
    nw = packed_words(n)
    bits = (m > 0).to(torch.int32)
    pad = nw * 32 - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (nw, 32))
    # Distinct bits never carry, so the int32 sum is the bitwise OR.
    return (bits << _shifts(m.device)).sum(dim=-1, dtype=torch.int32)


def unpack_spins(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_spins`: int8 spins in {-1,+1}, shape [..., n]."""
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    flat = bits.reshape(bits.shape[:-2] + (-1,))[..., :n]
    return torch.where(flat == 1, 1, -1).to(torch.int8)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 tensors holding uint32 words.

    torch has no popcount, and its ``>>`` on int32 is arithmetic, so the
    count is a SWAR reduction on the words widened to int64, where every
    step (the multiply included) stays far below 2^63.  Rejects other
    dtypes: a silent cast would mean the caller left the packed domain.
    """
    if x.dtype != torch.int32:
        raise TypeError(f"popcount_u32 expects int32 words, got {x.dtype}")
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


class PackedJ(NamedTuple):
    """Coupling matrix as bitplanes: the XNOR-popcount operand layout.

    For a symmetric integer J (``field_i = h_i + sum_j J_ij m_j``), as int32
    tensors holding uint32 words:

    sign:  (N, Nw) — bit j of row i is 1 ⇔ J_ij > 0.
    mags:  (n_bits, N, Nw) — bit j of plane b row i is bit b of |J_ij|.
    base:  (N,) — −Σ_b 2^b · popcount(mags[b, i]), so

               field = h + base + Σ_b 2^{b+1} · popcount(XNOR & mags[b])

    Every bit at a column ≥ N is zero in every plane, so tail bits of the
    spin words never reach a field.  ±1-weight instances (all of the G-set)
    have n_bits == 1.
    """

    sign: torch.Tensor
    mags: torch.Tensor
    base: torch.Tensor

    @property
    def n_bits(self) -> int:
        return self.mags.shape[-3]

    @property
    def n_words(self) -> int:
        return self.sign.shape[-1]


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Host-side pack of a 0/1 array [..., N] into uint32 words."""
    n = bits.shape[-1]
    nw = packed_words(n)
    pad = nw * 32 - n
    b = bits.astype(np.uint32)
    if pad:
        b = np.concatenate([b, np.zeros(b.shape[:-1] + (pad,), np.uint32)], axis=-1)
    b = b.reshape(b.shape[:-1] + (nw, 32))
    return (b << _SHIFTS_NP).sum(axis=-1, dtype=np.uint32)


def _popcount_np(words: np.ndarray) -> np.ndarray:
    """Host-side popcount summed over the word axis: [..., Nw] -> [...]."""
    u8 = np.ascontiguousarray(words).view(np.uint8)
    return np.unpackbits(u8, axis=-1).sum(axis=-1, dtype=np.int64)


def _resolve_n_bits(max_mag: int, n_bits) -> int:
    need = max(1, int(max_mag).bit_length())
    if n_bits is None:
        return need
    n_bits = int(n_bits)
    if n_bits < need:
        raise ValueError(
            f"couplings need {need} magnitude bitplanes, caller forced "
            f"{n_bits} — weights up to {max_mag} cannot be represented"
        )
    return n_bits


def _packed_j(sign: np.ndarray, mags: np.ndarray, base: np.ndarray, device) -> PackedJ:
    """PackedJ tensors on ``device`` from host uint32 planes and int base."""

    def words(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)

    return PackedJ(words(sign), words(mags),
                   torch.from_numpy(base.astype(np.int32)).to(device))


def pack_couplings(J: np.ndarray, n_bits=None, *, device=None) -> PackedJ:
    """Pack a dense symmetric integer coupling matrix into bitplanes.

    Raises on non-integral weights.  ``n_bits`` forces the magnitude-plane
    count (zero planes pad the top); it must cover max|J|.
    """
    J = np.asarray(J)
    Ji = np.asarray(np.rint(J), dtype=np.int64)
    if not np.array_equal(Ji, np.asarray(J, dtype=np.float64)):
        raise ValueError("pack_couplings requires integer weights")
    mag = np.abs(Ji)
    n_bits = _resolve_n_bits(mag.max(initial=0), n_bits)
    sign = _pack_bits_np(Ji > 0)
    mags = np.stack([_pack_bits_np((mag >> b) & 1) for b in range(n_bits)])
    degs = _popcount_np(mags)  # (n_bits, N)
    shifts = (np.int64(1) << np.arange(n_bits, dtype=np.int64))[:, None]
    return _packed_j(sign, mags, -(degs * shifts).sum(axis=0), device)


def _coalesced_adjacency(n: int, nbr_idx, nbr_w):
    """(rows, cols, weights) with duplicate (i, j) slots weight-summed."""
    idx = np.asarray(nbr_idx, dtype=np.int64)
    w = np.asarray(nbr_w, dtype=np.int64)
    rows = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], idx.shape)
    live = w != 0
    keys = rows[live] * n + idx[live]
    uniq, inv = np.unique(keys, return_inverse=True)
    wsum = np.zeros(uniq.shape[0], dtype=np.int64)
    np.add.at(wsum, inv, w[live])
    nz = wsum != 0
    uniq, wsum = uniq[nz], wsum[nz]
    return uniq // n, uniq % n, wsum


def adjacency_weight_bits(n: int, nbr_idx, nbr_w) -> int:
    """Magnitude bitplanes a model's coalesced couplings need (≥ 1): the
    count that ``field_mode='auto'`` compares with POPCOUNT_AUTO_MAX_BITS."""
    _, _, wsum = _coalesced_adjacency(int(n), nbr_idx, nbr_w)
    return max(1, int(np.abs(wsum).max(initial=0)).bit_length())


def pack_couplings_from_adjacency(n: int, nbr_idx: np.ndarray, nbr_w: np.ndarray,
                                  n_bits=None, *, device=None, rows=None) -> PackedJ:
    """Pack couplings from the padded adjacency without materialising J.

    ``nbr_idx``/``nbr_w`` are the ``IsingModel`` padded neighbour lists
    (weight 0 = padding slot); duplicate (i, j) entries are weight-summed
    first, matching ``IsingModel.dense_J``.  O(N·max_deg) host work.
    ``rows=(lo, hi)`` packs only rows [lo, hi) — a spin-sharded rank's row
    shard, every column kept — equal to those rows of the whole packing.
    """
    n = int(n)
    lo, hi = (0, n) if rows is None else (int(rows[0]), int(rows[1]))
    r, c, wsum = _coalesced_adjacency(n, nbr_idx, nbr_w)
    mag = np.abs(wsum)
    n_bits = _resolve_n_bits(mag.max(initial=0), n_bits)
    keep = (r >= lo) & (r < hi)
    r, c, wsum, mag = r[keep] - lo, c[keep], wsum[keep], mag[keep]
    word, bit = c // 32, (c % 32).astype(np.uint32)
    sign = np.zeros((hi - lo, packed_words(n)), np.uint32)
    pos = wsum > 0
    np.bitwise_or.at(sign, (r[pos], word[pos]), np.uint32(1) << bit[pos])
    mags = np.zeros((n_bits,) + sign.shape, np.uint32)
    base = np.zeros(hi - lo, np.int64)
    for b in range(n_bits):
        sel = ((mag >> b) & 1) == 1
        np.bitwise_or.at(mags[b], (r[sel], word[sel]), np.uint32(1) << bit[sel])
        np.add.at(base, r[sel], -(np.int64(1) << b))
    return _packed_j(sign, mags, base, device)


def packed_j_nbytes(n: int, n_bits: int = 1) -> int:
    """Bytes of a PackedJ layout: sign + n_bits magnitude planes + base."""
    nw = packed_words(n)
    return 4 * n * nw * (1 + int(n_bits)) + 4 * int(n)
