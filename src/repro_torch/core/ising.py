"""Ising-model substrate (port of ``repro.core.ising``).

H = - Σ_i h_i m_i - 1/2 Σ_{i,j} J_ij m_i m_j, spins m_i ∈ {-1,+1}.
MAX-CUT maps onto it with J_ij = -w_ij, h_i = 0.

The model keeps two views, built on the host with numpy exactly as the JAX
package builds them (same half-edge slot order):

* padded adjacency ``(nbr_idx, nbr_w)`` of shape ``(N, max_deg)`` — padding
  entries point at the row's own vertex with weight 0;
* the dense symmetric ``J`` of shape ``(N, N)``.

All coupling arithmetic is integer-valued; the dense contraction runs in
float32, which is exact while every field stays below 2^24 (checked at
construction).  On the GPU that needs TF32 off, which the dense backends
set (``core.engine.exact_float32_matmul``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.bitplane import PackedJ, popcount_u32

__all__ = [
    "IsingModel",
    "MaxCutProblem",
    "fig4_example",
    "ising_energy",
    "local_fields_dense",
    "local_fields_popcount",
    "local_fields_sparse",
    "local_fields_tiled",
]

# Exactness bound for the float32 matmul path: fields must stay below 2^24.
_F32_EXACT_BOUND = 1 << 24


@dataclasses.dataclass(frozen=True)
class IsingModel:
    """An Ising model with padded-adjacency and dense views (numpy, host).

    Attributes:
      n: number of spins.
      h: int32[n] biases.
      nbr_idx: int32[n, max_deg] neighbour indices (padded with self-index).
      nbr_w: int32[n, max_deg] coupling weights J_ij (padded with 0).
      name: human-readable instance name.
    """

    n: int
    h: np.ndarray
    nbr_idx: np.ndarray
    nbr_w: np.ndarray
    name: str = "ising"

    @property
    def max_degree(self) -> int:
        return int(self.nbr_idx.shape[1])

    @staticmethod
    def from_edges(
        n: int,
        edges: np.ndarray,
        weights: np.ndarray,
        h: Optional[np.ndarray] = None,
        name: str = "ising",
    ) -> "IsingModel":
        """Build from an undirected edge list (i, j, J_ij).

        Each edge contributes two half-edges, i→j then j→i; a stable sort by
        source vertex assigns the slots in that order, the same order as the
        JAX package.
        """
        w_in = np.asarray(weights)
        if np.issubdtype(w_in.dtype, np.floating) and not np.all(np.isfinite(w_in)):
            raise ValueError("weights must be finite (got NaN/inf)")
        h_in = None if h is None else np.asarray(h)
        if (
            h_in is not None
            and np.issubdtype(h_in.dtype, np.floating)
            and not np.all(np.isfinite(h_in))
        ):
            raise ValueError("h must be finite (got NaN/inf)")
        edges = np.asarray(edges, dtype=np.int64)
        weights = w_in.astype(np.int64)
        if edges.ndim != 2 or edges.shape[1] != 2:
            raise ValueError(f"edges must be (E,2), got {edges.shape}")
        if len(weights) != len(edges):
            raise ValueError("weights/edges length mismatch")
        if len(edges) and np.any(edges[:, 0] == edges[:, 1]):
            raise ValueError("self-loops are not Ising couplings")
        e32 = edges.astype(np.int32)
        src = e32.reshape(-1)                         # i0, j0, i1, j1, …
        dst = e32[:, ::-1].reshape(-1)                # j0, i0, j1, i1, …
        w2 = np.repeat(weights.astype(np.int32), 2)
        deg = np.bincount(src, minlength=n)
        max_deg = int(deg.max()) if len(edges) else 1
        nbr_idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, max_deg))
        nbr_w = np.zeros((n, max_deg), dtype=np.int32)
        if len(edges):
            order = np.argsort(src, kind="stable")
            ss, dd, ww = src[order], dst[order], w2[order]
            starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
            slot = (np.arange(len(ss)) - np.repeat(starts, deg)).astype(np.int64)
            nbr_idx[ss, slot] = dd
            nbr_w[ss, slot] = ww
        hh = np.zeros(n, dtype=np.int64) if h_in is None else h_in.astype(np.int64)
        model = IsingModel(
            n=n,
            h=hh.astype(np.int32),
            nbr_idx=nbr_idx.astype(np.int32),
            nbr_w=nbr_w.astype(np.int32),
            name=name,
        )
        bound = int(np.abs(hh).max(initial=0) + np.abs(nbr_w).sum(axis=1).max(initial=0))
        if bound >= _F32_EXACT_BOUND:
            raise ValueError(
                f"field bound {bound} exceeds float32-exact range; "
                "use a smaller weight scale"
            )
        return model

    @staticmethod
    def from_dense(J: np.ndarray, h: Optional[np.ndarray] = None,
                   name: str = "ising") -> "IsingModel":
        """Build from a symmetric, zero-diagonal coupling matrix: its upper
        triangle's nonzeros, row-major, become the edge list."""
        J = np.asarray(J)
        if np.issubdtype(J.dtype, np.floating) and not np.all(np.isfinite(J)):
            raise ValueError("J must be finite (got NaN/inf)")
        if not np.allclose(J, J.T):
            raise ValueError("J must be symmetric")
        if np.any(np.diag(J) != 0):
            raise ValueError("J must have zero diagonal")
        n = J.shape[0]
        ii, jj = np.nonzero(np.triu(J, k=1))
        edges = np.stack([ii, jj], axis=1)
        return IsingModel.from_edges(n, edges, J[ii, jj], h=h, name=name)

    def dense_J(self) -> np.ndarray:
        """Materialize the symmetric dense coupling matrix (int32)."""
        J = np.zeros((self.n, self.n), dtype=np.int64)
        rows = np.repeat(np.arange(self.n), self.max_degree)
        np.add.at(J, (rows, self.nbr_idx.reshape(-1)), self.nbr_w.reshape(-1))
        return J.astype(np.int32)  # padded entries are (i, i, 0): harmless

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray]:
        """The unique undirected edges (E, 2), row-major, and weights (E,)."""
        J = self.dense_J()
        ii, jj = np.nonzero(np.triu(J, k=1))
        return np.stack([ii, jj], axis=1), J[ii, jj]

    def device_arrays(self, device=None):
        """int32 tensors (h, nbr_idx, nbr_w) on ``device``."""
        return tuple(
            torch.as_tensor(a, dtype=torch.int32, device=device)
            for a in (self.h, self.nbr_idx, self.nbr_w)
        )


# ---------------------------------------------------------------------------
# Local-field and energy math.  Spins are ±1 tensors of shape [..., N]; every
# sum is kept in int32 (torch would otherwise widen integer sums to int64).
# ---------------------------------------------------------------------------
def local_fields_sparse(m, h, nbr_idx, nbr_w):
    """h_i + Σ_j J_ij m_j over the padded adjacency, int32."""
    neigh = m.to(torch.int32)[..., nbr_idx]  # [..., N, D]
    return h + (nbr_w * neigh).sum(dim=-1, dtype=torch.int32)


def local_fields_dense(m, h, J_f32):
    """h + m @ J in float32: exact for |field| < 2^24 (checked at build)."""
    return h + torch.matmul(m.to(torch.float32), J_f32).to(torch.int32)


def local_fields_tiled(m, h, nbr_idx, nbr_w, *, tile_n: int = 512):
    """``h + m @ J`` without ever holding the (N, N) coupling matrix.

    Streams J one (tile_n, N) float32 row slab at a time: each slab is
    scattered from the padded adjacency (integer-valued, exact) and
    contracted against the whole spin state, so the only J-shaped buffer
    alive is one slab — 32 MB at N = 16384 and tile_n = 512, against 1 GiB
    for the dense J.  Bit-identical to :func:`local_fields_dense`: both are
    integer-valued float32 contractions below the 2^24 exactness bound.

    The contraction is rectangular: the row count R comes from the
    adjacency (``nbr_idx``/``nbr_w`` (..., R, D), ``h`` (..., R)) and the
    column count from the spins ``m`` (..., T, N); the last slab may be
    ragged (``tile_n`` need not divide R).  Leading axes of the adjacency
    are problem axes, matched against those of ``m`` ahead of its trial
    axis (the batched backends pass (B, R, D) against (B, T, N)).
    """
    n_rows, n_cols = nbr_idx.shape[-2], m.shape[-1]
    tile_n = int(tile_n)
    if tile_n < 1:
        raise ValueError(f"tile_n must be >= 1, got {tile_n}")
    mf = m.to(torch.float32)
    w = nbr_w.to(torch.float32)
    idx = nbr_idx.to(torch.int64)
    lead = idx.shape[:-2]
    cols = []
    for t in range(0, n_rows, tile_n):
        it, wt = idx[..., t:t + tile_n, :], w[..., t:t + tile_n, :]
        slab = torch.zeros(lead + (it.shape[-2], n_cols), dtype=torch.float32,
                           device=m.device).scatter_add_(-1, it, wt)
        cols.append(torch.matmul(mf, slab.transpose(-1, -2)).to(torch.int32))
    return h + torch.cat(cols, dim=-1)


def _popcount_fields_block(m_words, sign, mags):
    """XNOR-popcount contraction of one row block, minus the h/base terms.

    m_words: int32[..., Nw] packed spins; sign: int32[..., R, Nw];
    mags: int32[..., n_bits, R, Nw] (words as uint32 bit patterns).
    Returns int32[..., R]: Σ_b 2^{b+1} · popcount(XNOR(m, sign_r) & mags[b, r]).
    """
    # XNOR(a, b) = a ^ ~b; the AND with the magnitude mask confines the
    # contraction to real couplings (tail bits are 0 there).
    x = m_words[..., None, :] ^ ~sign  # [..., R, Nw]
    acc = popcount_u32(x & mags[..., 0, :, :]).sum(dim=-1, dtype=torch.int32) << 1
    for b in range(1, mags.shape[-3]):
        pc = popcount_u32(x & mags[..., b, :, :]).sum(dim=-1, dtype=torch.int32)
        acc = acc + (pc << (b + 1))
    return acc


def local_fields_popcount(m_words, h, packed_j: PackedJ, *, tile_n: Optional[int] = None):
    """Field contraction on 32-bit bitplanes, all in int32 (and the int64
    of the popcount itself): no float value anywhere.

        field_i = h_i + base_i + Σ_b 2^{b+1}·popcount(XNOR(m, sign_i) & mag_bi)

    equals ``h + m @ J`` exactly for any integer J.  ``m_words`` are int32
    packed spins [..., Nw] (tail bits may hold anything: the magnitude masks
    kill them).  ``tile_n`` row-tiles the contraction so the broadcast XNOR
    buffer stays O(tile_n·Nw) per trial; None contracts all rows at once.
    """
    sign, mags, base = packed_j
    n = sign.shape[-2]
    if tile_n is None or int(tile_n) >= n:
        return h + base + _popcount_fields_block(m_words, sign, mags)
    tile_n = int(tile_n)
    cols = [
        _popcount_fields_block(m_words, sign[..., t:t + tile_n, :], mags[..., t:t + tile_n, :])
        for t in range(0, n, tile_n)
    ]
    return h + base + torch.cat(cols, dim=-1)


def ising_energy(m, h, nbr_idx, nbr_w):
    """H = -Σ h_i m_i - 1/2 Σ_ij J_ij m_i m_j (Eq. 1), int32 exact."""
    m32 = m.to(torch.int32)
    fields = local_fields_sparse(m32, torch.zeros_like(h), nbr_idx, nbr_w)
    pair = (m32 * fields).sum(dim=-1, dtype=torch.int32) // 2
    return -((h * m32).sum(dim=-1, dtype=torch.int32) + pair)


@dataclasses.dataclass(frozen=True)
class MaxCutProblem:
    """A MAX-CUT instance G=(V,E,w) and its Ising embedding (J = -w, h = 0).

    cut(m) = Σ_{(i,j)∈E} w_ij (1 - m_i m_j) / 2 = (w_total - H) / 2.
    """

    n: int
    edges: np.ndarray  # (E, 2) int
    weights: np.ndarray  # (E,) int
    name: str = "maxcut"
    best_known: Optional[int] = None

    @property
    def w_total(self) -> int:
        return int(np.sum(self.weights))

    def to_ising(self) -> IsingModel:
        return IsingModel.from_edges(
            self.n, self.edges, -np.asarray(self.weights), name=f"{self.name}-ising"
        )

    def cut_value(self, m) -> np.ndarray:
        """Cut value of spin assignment m ([..., N] in {-1,+1}), numpy."""
        m = np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m, np.int64)
        mi = m[..., self.edges[:, 0]]
        mj = m[..., self.edges[:, 1]]
        return np.sum(np.asarray(self.weights) * (1 - mi * mj), axis=-1) // 2

    def cut_from_energy(self, H):
        """cut = (w_total - H) // 2 (J = -w, h = 0)."""
        return (self.w_total - H) // 2



def fig4_example() -> MaxCutProblem:
    """The 4-vertex example of the paper's Fig. 4 (optimal cut = 3): edges
    A-B (w=-1), A-C, A-D, B-C (+1) and C-D (-1)."""
    edges = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [2, 3]])
    weights = np.array([-1, 1, 1, 1, -1])
    return MaxCutProblem(n=4, edges=edges, weights=weights, name="fig4", best_known=3)
