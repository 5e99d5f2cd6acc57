"""Number partitioning as the classic fully-connected Ising model.

Split integers v into two subsets minimizing the sum difference:

    residual(m) = |Σ_i v_i m_i|,   minimize residual²

Direct Ising form (no QUBO detour): (Σ v m)² = Σ v² + Σ_{i≠j} v_i v_j m_i m_j,
so J_ij = -2 v_i v_j, h = 0 gives H(m) = Σ_{i≠j} v_i v_j m_i m_j =
residual² − Σ v² — i.e. ``residual² = H(m) + offset`` with offset = Σ v².

Every spin vector is a valid split, so ``verify`` only checks shape; the
objective is the residual (minimize; the parity of Σv floors it at 0 or 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.ising import IsingModel

from .base import ProblemEncoding

__all__ = ["PartitionProblem", "partition_problem", "random_partition"]


@dataclasses.dataclass(frozen=True)
class PartitionProblem(ProblemEncoding):
    """Encoded partitioning instance; ``residual² = H(m) + offset``."""

    values: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, int))

    def decode(self, m: np.ndarray) -> np.ndarray:
        """Spins → subset membership (±1 per value)."""
        return np.where(np.asarray(m) > 0, 1, -1).astype(np.int64)

    def verify(self, solution: np.ndarray) -> bool:
        s = np.asarray(solution)
        return s.shape == (len(self.values),) and bool(np.all(np.abs(s) == 1))

    def objective(self, solution: np.ndarray) -> int:
        """|sum(A) − sum(B)| over the two subsets."""
        return int(abs((self.values * np.asarray(solution, np.int64)).sum()))


def partition_problem(values: np.ndarray) -> PartitionProblem:
    """Encode a partitioning instance: J_ij = -2 v_i v_j, h = 0."""
    v = np.asarray(values, dtype=np.int64)
    J = -2 * np.outer(v, v)
    np.fill_diagonal(J, 0)
    model = IsingModel.from_dense(J, name=f"partition{len(v)}")
    return PartitionProblem(
        kind="partition",
        model=model,
        offset=int((v * v).sum()),
        values=v,
    )


def random_partition(n: int = 24, *, seed: int = 0, hi: int = 50) -> PartitionProblem:
    """Uniform random integers in [1, hi] — the smoke/benchmark family."""
    rng = np.random.default_rng(seed)
    return partition_problem(rng.integers(1, hi + 1, size=n))
