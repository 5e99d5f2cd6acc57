"""Bitplane codec: ±1 spins as 32-bit sign-bit words.

Port of the spin half of ``repro.kernels.bitplane``.  A spin vector
``m ∈ {-1,+1}^N`` becomes ``ceil(N/32)`` words, bit ``k`` of word ``w``
holding the sign of spin ``n = 32·w + k`` (1 ⇔ +1); tail bits at index
≥ N are 0.  Words are carried as ``int32`` tensors holding the uint32 bit
patterns (torch has no shifts on ``uint32``); ``.numpy().view(np.uint32)``
gives the JAX package's words.
"""
from __future__ import annotations

import torch

__all__ = ["packed_words", "packed_nbytes", "pack_spins", "unpack_spins"]


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
