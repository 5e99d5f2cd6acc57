"""Carry models, engine states, SA carries and problem encodings across
packages as numpy arrays.

The JAX package and this port agree on every layout, but not on dtypes:
this port carries uint32 words (xorshift lanes, packed spins) as int32
tensors.  These helpers convert at that boundary and import nothing of the
JAX package — a caller passes plain numpy arrays in and gets them out.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .core.engine import EngineState, PackedEngineState
from .core.ising import IsingModel
from .core.sa import SACarry
from .kernels.bitplane import PackedJ
from .problems import ColoringProblem, MISProblem, PartitionProblem, QUBOProblem

__all__ = ["ising_from_arrays", "engine_state_from_arrays", "engine_state_to_arrays",
           "packed_j_from_arrays", "sa_carry_from_arrays", "sa_carry_to_arrays",
           "encoding_from_fields"]

_ENCODINGS = {"qubo": QUBOProblem, "mis": MISProblem, "coloring": ColoringProblem,
              "partition": PartitionProblem}


def ising_from_arrays(
    n: int,
    h: np.ndarray,
    nbr_idx: np.ndarray,
    nbr_w: np.ndarray,
    edges: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    name: str = "ising",
) -> IsingModel:
    """The port's model from another package's (h, nbr_idx, nbr_w) arrays.

    With ``edges``/``weights`` the model is rebuilt by
    :meth:`IsingModel.from_edges`, and a slot order that differs from the
    given arrays raises ValueError.
    """
    model = IsingModel(
        n=int(n),
        h=np.asarray(h, np.int32),
        nbr_idx=np.asarray(nbr_idx, np.int32),
        nbr_w=np.asarray(nbr_w, np.int32),
        name=name,
    )
    if edges is not None:
        rebuilt = IsingModel.from_edges(int(n), edges, weights, h=h, name=name)
        for a in ("h", "nbr_idx", "nbr_w"):
            if not np.array_equal(getattr(rebuilt, a), getattr(model, a)):
                raise ValueError(f"{a} differs from the edge list's slot order")
    return model


def _as_i32(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=True)).to(device)


def packed_j_from_arrays(sign: np.ndarray, mags: np.ndarray, base: np.ndarray,
                         device=None) -> PackedJ:
    """The port's :class:`PackedJ` from another package's coupling planes:
    ``sign`` (..., N, Nw) and ``mags`` (..., n_bits, N, Nw) uint32 words,
    ``base`` (..., N) integers."""
    return PackedJ(_as_i32(sign, device), _as_i32(mags, device), _as_i32(base, device))


def engine_state_from_arrays(
    noise_state: np.ndarray,
    m: np.ndarray,
    itanh: np.ndarray,
    best_H: np.ndarray,
    best_m: np.ndarray,
    *,
    packed: bool = False,
    device=None,
) -> Union[EngineState, PackedEngineState]:
    """Build an engine state from numpy arrays.

    ``noise_state`` is the (4, T, N) uint32 xorshift lanes or a (2,) uint32
    threefry key; ``m``/``best_m`` are (T, N) ±1 spins, or (T, ceil(N/32))
    uint32 words when ``packed``.
    """
    key = np.asarray(noise_state)
    if key.shape == (2,):
        ns = tuple(int(k) for k in key.astype(np.uint32))
    else:
        ns = _as_i32(noise_state, device)
    it = _as_i32(itanh, device)
    bh = _as_i32(best_H, device)
    if packed:
        return PackedEngineState(ns, _as_i32(m, device), it, bh, _as_i32(best_m, device))
    spins = [torch.from_numpy(np.asarray(a, np.int8).copy()).to(device) for a in (m, best_m)]
    return EngineState(ns, spins[0], it, bh, spins[1])


def engine_state_to_arrays(
    state: Union[EngineState, PackedEngineState],
) -> Tuple[np.ndarray, ...]:
    """(noise_state, m, itanh, best_H, best_m) as numpy arrays, with the
    lanes (or the threefry key) and packed words as uint32 and unpacked
    spins as int8."""
    if isinstance(state.noise_state, tuple):
        state = state._replace(noise_state=torch.tensor(
            np.asarray(state.noise_state, np.uint32).view(np.int32)))
    ns, m, it, bh, bm = (t.cpu().numpy() for t in state)
    if isinstance(state, PackedEngineState):
        m, bm = m.view(np.uint32), bm.view(np.uint32)
    return ns.view(np.uint32), m, it, bh, bm


def sa_carry_from_arrays(key: np.ndarray, m: np.ndarray, H: np.ndarray, best_H: np.ndarray,
                         best_m: np.ndarray, *, device=None):
    """An SA carry from numpy arrays: one problem's ``(key, m, H, best_H,
    best_m)`` tuple (key (2,) uint32, spins (T, N)), or a batched
    :class:`~repro_torch.core.sa.SACarry` when the key is (B, 2)."""
    key = np.asarray(key).astype(np.uint32).astype(np.int64)
    leaves = [torch.from_numpy(np.asarray(a, np.int32).copy()).to(device)
              for a in (m, H, best_H, best_m)]
    if key.shape == (2,):
        return (tuple(int(k) for k in key), *leaves)
    return SACarry(key.reshape(-1, 2), *leaves)


def sa_carry_to_arrays(carry) -> Tuple[np.ndarray, ...]:
    """(key uint32, m, H, best_H, best_m int32) of an SA carry, either form."""
    key, *leaves = carry
    return (np.asarray(key, np.int64).astype(np.uint32),
            *(t.cpu().numpy() for t in leaves))


def encoding_from_fields(model: dict, **fields):
    """The port's encoding from another package's fields: ``model`` holds
    the Ising arrays (``n``, ``h``, ``nbr_idx``, ``nbr_w``, ``name``),
    ``fields`` the encoding's other dataclass fields (``kind``, which picks
    the family, ``offset``, ``minimize`` and the instance data: ``Q``,
    ``edges``, ``values``, …) as numpy arrays or scalars."""
    cls = _ENCODINGS[fields["kind"]]
    fields = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in fields.items()}
    return cls(model=ising_from_arrays(**model), **fields)
