"""Plain PyTorch versions of the CUDA kernels (the correctness contract).

Each function computes exactly what its kernel computes, in plain tensor
code: the wrappers in :mod:`.ssa_update` run these on CPU tensors, the CPU
tests hold them against the JAX package's Pallas kernels, and the chip
smoke test holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.ising import local_fields_popcount
from ..core.rng import xorshift_next_bits
from .bitplane import PackedJ, pack_spins, unpack_spins

__all__ = ["local_field_ref", "replica_coupling", "ssa_plateau_packed_ref",
           "ssa_plateau_popcount_ref", "ssa_plateau_ref"]


def replica_coupling(m: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """SSQA's Trotter-ring coupling: int32 ``m[k-1] + m[k+1]`` per (trial,
    spin), where the trial axis (axis -2 of ``(..., T, N)`` spins) holds
    T/R rings of R consecutive replicas, closed at their ends.  With R = 2
    the one neighbour counts from both sides (2·m_other), as ``jnp.roll``
    gives it in the JAX package."""
    R = int(n_replicas)
    *lead, T, N = m.shape
    if T % R:
        raise ValueError(f"n_trials {T} not divisible by n_replicas {R}")
    mr = m.to(torch.int32).reshape(*lead, T // R, R, N)
    nb = torch.roll(mr, 1, dims=-2) + torch.roll(mr, -1, dims=-2)
    return nb.reshape(*lead, T, N)


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
    jperp: int = 0,
    n_replicas: int = 0,
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

    ``n_replicas > 0`` is the SSQA ring mode: the update (not the energy)
    adds ``jperp · replica_coupling(m, n_replicas)`` of the state current
    at the cycle.

    Returns (m_packed, itanh, rng, best_H, best_m_packed).
    """
    n = itanh.shape[-1]
    i0, jperp = int(i0), int(jperp)
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
        if n_replicas:
            f = f + jperp * replica_coupling(m, n_replicas)
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


def ssa_plateau_popcount_ref(
    m_packed: torch.Tensor,       # (B, R, Nw) int32 words
    itanh: torch.Tensor,          # (B, R, N) int32
    sign: torch.Tensor,           # (B, N, Nw) int32 words, PackedJ.sign
    mags: torch.Tensor,           # (B, nb, N, Nw) int32 words, PackedJ.mags
    base: torch.Tensor,           # (B, N) int32, PackedJ.base
    h: torch.Tensor,              # (B, N) int32
    rng: torch.Tensor,            # (B, 4, R, N) int32 xorshift lanes
    i0_sched: torch.Tensor,       # (C,) int32 per-cycle I0
    fold_sched: torch.Tensor,     # (C+1,) int32 per-state fold write-enable
    best_H: torch.Tensor,         # (B, R) int32
    best_m_packed: torch.Tensor,  # (B, R, Nw) int32 words
    *,
    n_rnd: int = 2,
    jperp_sched: Optional[torch.Tensor] = None,  # (C,) int32 per-cycle J⊥
    n_replicas: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """A plateau chain of C = ``len(i0_sched)`` cycles for B problems, with
    the XNOR-popcount field; integer arithmetic only.

    Each cycle c: field = h + base + Σ_b 2^(b+1)·popcount(XNOR(m, sign) &
    mags[b]); when ``fold_sched[c] > 0``, fold H = -(h·m + m·field)/2 of the
    state current at c into the running best (strict ``<``, so the first
    minimum is kept; the best words are the state's words as they stand);
    step the xorshift lanes and take the new word's MSB as ±1 noise;
    Itanh = clamp(field + n_rnd·r + Itanh, -i0_sched[c], i0_sched[c]-1);
    m = sign(Itanh).  After the loop, ``fold_sched[C]`` folds the final
    state with one more field.  Spin words come out with zero tail bits,
    as the JAX kernel's do for ``n_rnd >= 1``.

    With ``jperp_sched`` (SSQA ring mode, ``n_replicas`` > 0) the update of
    cycle c adds ``jperp_sched[c] · replica_coupling(m, n_replicas)`` of the
    state current at c; the energy keeps the base field.

    Returns (m_packed, itanh, rng, best_H, best_m_packed).
    """
    n = itanh.shape[-1]
    i0s = [int(v) for v in i0_sched.tolist()]
    jps = None if jperp_sched is None else [int(v) for v in jperp_sched.tolist()]
    folds = [int(v) > 0 for v in fold_sched.tolist()]
    if len(folds) != len(i0s) + 1:
        raise ValueError(f"fold_sched needs C+1 = {len(i0s) + 1} entries, got {len(folds)}")
    pj = PackedJ(sign[:, None], mags[:, None], base[:, None])
    hb = h.to(torch.int32)[:, None, :]
    mw, lanes = m_packed, rng.transpose(0, 1)
    bh, bmp = best_H, best_m_packed

    def fold(mw, f, bh, bmp):
        m32 = unpack_spins(mw, n).to(torch.int32)
        H = -((hb * m32).sum(-1, dtype=torch.int32)
              + (m32 * f).sum(-1, dtype=torch.int32)) // 2
        better = H < bh
        return torch.where(better, H, bh), torch.where(better[..., None], mw, bmp)

    for c, i0 in enumerate(i0s):
        f = local_fields_popcount(mw, hb, pj)
        if folds[c]:
            bh, bmp = fold(mw, f, bh, bmp)
        lanes, r = xorshift_next_bits(lanes)
        if jps is not None:
            f = f + jps[c] * replica_coupling(unpack_spins(mw, n), n_replicas)
        itanh = torch.clamp(f + n_rnd * r + itanh, -i0, i0 - 1)
        mw = pack_spins(torch.where(itanh >= 0, 1, -1))
    if folds[-1]:
        bh, bmp = fold(mw, local_fields_popcount(mw, hb, pj), bh, bmp)
    return mw, itanh, lanes.transpose(0, 1).contiguous(), bh, bmp
