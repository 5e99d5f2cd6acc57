"""Plain PyTorch versions of the CUDA kernels (the correctness contract).

Each function computes exactly what its kernel computes, in plain tensor
code: the wrappers in :mod:`.ssa_update` run these on CPU tensors, the CPU
tests hold them against the JAX package's Pallas kernels, and the chip
smoke test holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.rng import xorshift_next_bits
from .bitplane import pack_spins, unpack_spins

__all__ = ["local_field_ref", "ssa_plateau_packed_ref", "ssa_plateau_ref"]


def local_field_ref(m: torch.Tensor, h: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """field = h + m @ J, int32 exact (float32 sums of integers < 2^24)."""
    acc = torch.matmul(m.to(torch.float32), J.to(torch.float32))
    return (acc + h.to(torch.float32)).to(torch.int32)


def ssa_plateau_packed_ref(
    m_packed: torch.Tensor,       # (B, R, Nw) int32 words
    itanh: torch.Tensor,          # (B, R, N) int32
    J: torch.Tensor,              # (B, N, N) float32 | bfloat16, integer-valued
    h: torch.Tensor,              # (B, N) int32
    rng: torch.Tensor,            # (B, 4, R, N) int32 xorshift lanes
    i0: int,
    best_H: torch.Tensor,         # (B, R) int32
    best_m_packed: torch.Tensor,  # (B, R, Nw) int32 words
    *,
    n_cycles: int,
    n_rnd: int = 2,
    eligible: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """One constant-I0 plateau of ``n_cycles`` cycles for B problems.

    Each cycle: field = m @ J + h; at c ≥ 1, when ``eligible``, fold
    H = -(h·m + m·field)/2 into the running best (strict ``<``, so the first
    minimum is kept); step the xorshift lanes and take the new word's MSB
    as ±1 noise; Itanh = clamp(field + n_rnd·r + Itanh, -I0, I0-1);
    m = sign(Itanh).  After the loop one more field folds the final state.
    A best word is replaced whole when its trial improves, so tail bits of
    an unimproved best word pass through; spin words come out with zero
    tail bits.

    Returns (m_packed, itanh, rng, best_H, best_m_packed).
    """
    n = itanh.shape[-1]
    i0 = int(i0)
    Jf = J.to(torch.float32)
    hb = h.to(torch.int32)[:, None, :]
    m = unpack_spins(m_packed, n)
    lanes = rng.transpose(0, 1)
    bh, bmp = best_H, best_m_packed

    def field(m):
        acc = torch.matmul(m.to(torch.float32), Jf)
        return (acc + hb.to(torch.float32)).to(torch.int32)

    def fold(m, f, bh, bmp):
        m32 = m.to(torch.int32)
        H = -((hb * m32).sum(-1, dtype=torch.int32)
              + (m32 * f).sum(-1, dtype=torch.int32)) // 2
        better = H < bh
        return (torch.where(better, H, bh),
                torch.where(better[..., None], pack_spins(m), bmp))

    for c in range(int(n_cycles)):
        f = field(m)
        if eligible and c >= 1:
            bh, bmp = fold(m, f, bh, bmp)
        lanes, r = xorshift_next_bits(lanes)
        itanh = torch.clamp(f + n_rnd * r + itanh, -i0, i0 - 1)
        m = torch.where(itanh >= 0, 1, -1).to(torch.int8)
    if eligible:
        bh, bmp = fold(m, field(m), bh, bmp)
    return pack_spins(m), itanh, lanes.transpose(0, 1).contiguous(), bh, bmp


def ssa_plateau_ref(
    m: torch.Tensor,       # (B, R, N) float32 ±1
    itanh: torch.Tensor,   # (B, R, N) int32
    J: torch.Tensor,       # (B, N, N) float32 | bfloat16, integer-valued
    h: torch.Tensor,       # (B, N) int32
    noise: torch.Tensor,   # (B, C, R, N) int8 ±1
    i0: int,
    best_H: torch.Tensor,  # (B, R) int32
    best_m: torch.Tensor,  # (B, R, N) int8
    *,
    n_rnd: int = 2,
    eligible: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """One constant-I0 plateau of C = ``noise.shape[1]`` cycles with
    pregenerated noise, for B problems.

    Each cycle c: field = m @ J + h; at c ≥ 1, when ``eligible``, fold
    H = -(h·m + m·field)/2 into the running best (strict ``<``, so the first
    minimum is kept); Itanh = clamp(field + n_rnd·noise[c] + Itanh, -I0,
    I0-1); m = sign(Itanh).  After the loop one more field folds the final
    state.

    Returns (m float32, itanh, best_H, best_m int8).
    """
    i0 = int(i0)
    Jf = J.to(torch.float32)
    hb = h.to(torch.int32)[:, None, :]
    m = m.to(torch.float32)
    bh, bm = best_H.to(torch.int32), best_m.to(torch.int8)

    def fold(m, f, bh, bm):
        m32 = m.to(torch.int32)
        H = -((hb * m32).sum(-1, dtype=torch.int32)
              + (m32 * f).sum(-1, dtype=torch.int32)) // 2
        better = H < bh
        return (torch.where(better, H, bh),
                torch.where(better[..., None], m.to(torch.int8), bm))

    for c in range(noise.shape[1]):
        f = local_field_ref(m, hb, Jf)
        if eligible and c >= 1:
            bh, bm = fold(m, f, bh, bm)
        itanh = torch.clamp(f + n_rnd * noise[:, c].to(torch.int32) + itanh,
                            -i0, i0 - 1)
        m = torch.where(itanh >= 0, 1.0, -1.0)
    if eligible:
        bh, bm = fold(m, local_field_ref(m, hb, Jf), bh, bm)
    return m, itanh, bh, bm
