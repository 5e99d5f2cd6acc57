"""Generic QUBO — minimize xᵀQx over x ∈ {0,1}ⁿ (DESIGN.md §9).

The workhorse reduction every other family builds on.  With x = (1+m)/2 and
the objective scaled by 4 to keep every coupling integral:

    4·xᵀQx = H(m) + offset,   J_ij = -(Q_ij + Q_ji) (i≠j),  h_i = -ΣQ row/col

(the exact expansion is in :func:`qubo_to_ising`).  QUBO is unconstrained,
so every spin vector decodes to a feasible solution — ``verify`` is always
true and the annealer's job is purely objective quality.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.ising import IsingModel

from .base import ProblemEncoding, spins_to_bits

__all__ = ["QUBOProblem", "qubo_problem", "qubo_to_ising", "random_qubo"]


def qubo_to_ising(Q: np.ndarray, name: str = "qubo") -> Tuple[IsingModel, int]:
    """Minimize xᵀQx over x∈{0,1}ⁿ as an Ising model (integer couplings).

    With x = (1+m)/2:  xᵀQx = ¼ Σ_ij Q_ij (1+m_i)(1+m_j).  Multiplying the
    objective by 4 keeps everything integral:

        4·xᵀQx = Σ_ij Q_ij (1 + m_i + m_j + m_i m_j)
               = sum(Q) + Σ_i m_i (rowQ_i + colQ_i) + Σ_ij Q_ij m_i m_j

    and with H = -Σ h m - ½ Σ_{i≠j} J m m this pins h_i = -(rowQ_i + colQ_i),
    J_ij = -(Q_ij + Q_ji) and offset = sum(Q) + Σ_i Q_ii.  Returns
    ``(model, offset)`` with ``4·xᵀQx = H(m) + offset`` exactly — verified
    over all assignments in tests.
    """
    Q = np.asarray(Q, dtype=np.int64)
    n = Q.shape[0]
    S = Q + Q.T  # symmetric part ×2
    const = int(Q.sum())
    lin = Q.sum(axis=1) + Q.sum(axis=0)  # coefficient of m_i
    quad = S.copy()
    diag = np.diag(quad).copy()
    np.fill_diagonal(quad, 0)
    # Σ_ij Q_ij m_i m_j = ½ Σ_{i≠j} S_ij m_i m_j + Σ_i Q_ii (m_i² = 1)
    const += int(diag.sum() // 2)  # diag of S is 2·Q_ii
    h = -lin
    J = -quad
    model = IsingModel.from_dense(J.astype(np.int64), h=h.astype(np.int64), name=name)
    return model, const


@dataclasses.dataclass(frozen=True)
class QUBOProblem(ProblemEncoding):
    """Encoded QUBO instance; ``4·xᵀQx = H(m) + offset``."""

    Q: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 0)))

    def decode(self, m: np.ndarray) -> np.ndarray:
        return spins_to_bits(m)

    def verify(self, solution: np.ndarray) -> bool:
        x = np.asarray(solution)
        return x.shape == (self.Q.shape[0],) and bool(np.all((x == 0) | (x == 1)))

    def objective(self, solution: np.ndarray) -> int:
        x = np.asarray(solution, dtype=np.int64)
        return int(x @ self.Q @ x)


def qubo_problem(Q: np.ndarray, name: str = "qubo") -> QUBOProblem:
    """Encode a dense integer QUBO matrix (minimization)."""
    Q = np.asarray(Q, dtype=np.int64)
    if Q.ndim != 2 or Q.shape[0] != Q.shape[1]:
        raise ValueError(f"Q must be square, got {Q.shape}")
    model, offset = qubo_to_ising(Q, name=name)
    return QUBOProblem(kind="qubo", model=model, offset=offset, Q=Q)


def random_qubo(
    n: int = 32, *, seed: int = 0, lo: int = -8, hi: int = 8
) -> QUBOProblem:
    """Dense random integer QUBO — the smoke/benchmark instance family."""
    rng = np.random.default_rng(seed)
    Q = rng.integers(lo, hi + 1, size=(n, n))
    return qubo_problem(Q, name=f"qubo{n}s{seed}")
