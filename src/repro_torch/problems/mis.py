"""Maximum independent set (MIS) as a QUBO/Ising reduction (DESIGN.md §9).

    maximize |S|  s.t.  no edge inside S
    ⇒ minimize  -Σ_i x_i + P·Σ_{(i,j)∈E} x_i x_j,   P ≥ 2

With integer penalty P ≥ 2, removing a violating endpoint never worsens the
QUBO objective, so every ground state is a (maximum) independent set.

``decode`` applies the canonical deterministic repair — while any edge has
both endpoints selected, drop the endpoint with the most in-set conflicts
(ties to the lowest vertex index) — so a decoded solution is *always*
feasible; ``verify`` independently checks independence against the edge
list.  The objective is the set size (maximize).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .base import ProblemEncoding, spins_to_bits
from .qubo import qubo_to_ising

__all__ = ["MISProblem", "mis_problem", "random_mis_graph"]


@dataclasses.dataclass(frozen=True)
class MISProblem(ProblemEncoding):
    """Encoded MIS instance over an undirected edge list."""

    n_vertices: int = 0
    edges: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2), int))
    penalty: int = 2

    def decode(self, m: np.ndarray) -> np.ndarray:
        """Spins → independent set (bool mask), via deterministic repair."""
        sel = spins_to_bits(m).astype(bool)
        edges = np.asarray(self.edges)
        if len(edges) == 0:
            return sel
        while True:
            inside = sel[edges[:, 0]] & sel[edges[:, 1]]
            if not inside.any():
                return sel
            conflicts = np.zeros(self.n_vertices, dtype=np.int64)
            np.add.at(conflicts, edges[inside, 0], 1)
            np.add.at(conflicts, edges[inside, 1], 1)
            sel[int(np.argmax(conflicts))] = False  # argmax ties → lowest index

    def verify(self, solution: np.ndarray) -> bool:
        sel = np.asarray(solution, dtype=bool)
        if sel.shape != (self.n_vertices,):
            return False
        if len(self.edges) == 0:
            return True
        return not bool((sel[self.edges[:, 0]] & sel[self.edges[:, 1]]).any())

    def objective(self, solution: np.ndarray) -> int:
        return int(np.asarray(solution, dtype=bool).sum())


def mis_problem(n: int, edges: np.ndarray, penalty: int = 2) -> MISProblem:
    """Encode an MIS instance; ``4·(P·conflicts − |S|) = H(m) + offset``."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if penalty < 2:
        raise ValueError("MIS penalty must be >= 2 to dominate the size reward")
    Q = np.zeros((n, n), dtype=np.int64)
    np.fill_diagonal(Q, -1)  # reward −1 per selected vertex
    for i, j in edges:
        Q[i, j] += penalty  # conflict penalty on each undirected edge
    model, offset = qubo_to_ising(Q, name=f"mis{n}")
    return MISProblem(
        kind="mis",
        model=model,
        offset=offset,
        minimize=False,
        n_vertices=n,
        edges=edges,
        penalty=int(penalty),
    )


def random_mis_graph(n: int = 48, *, seed: int = 0, p: float = 0.12) -> MISProblem:
    """Erdős–Rényi G(n, p) MIS instance — the smoke/benchmark family."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    mask = rng.random(len(iu[0])) < p
    edges = np.stack([iu[0][mask], iu[1][mask]], axis=1)
    return mis_problem(n, edges)
