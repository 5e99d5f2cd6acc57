"""Graph k-coloring as a one-hot QUBO/Ising reduction (DESIGN.md §9).

Spins x[v, c] = vertex v has color c (n·k spins):

    minimize  A·Σ_v (Σ_c x_vc − 1)²  +  B·Σ_{(u,v)∈E} Σ_c x_uc x_vc

The A-term forces exactly one color per vertex, the B-term charges one unit
per monochromatic edge.  A > B·max_degree guarantees ground states are
one-hot; a proper k-coloring exists iff the minimum is the constant offset.

``decode`` is total: each vertex takes its first selected color (ties and
all-unselected rows fall back to color 0), so the solution is always a full
assignment; feasibility — properness, i.e. zero conflicting edges — is what
``verify`` checks and the annealer must earn.  The objective is the number
of conflicting edges (minimize; 0 = proper).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .base import ProblemEncoding
from .qubo import qubo_to_ising

__all__ = ["ColoringProblem", "coloring_problem", "ring_coloring"]


@dataclasses.dataclass(frozen=True)
class ColoringProblem(ProblemEncoding):
    """Encoded k-coloring instance; spins index (vertex, color) row-major."""

    n_vertices: int = 0
    n_colors: int = 0
    edges: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2), int))

    def decode(self, m: np.ndarray) -> np.ndarray:
        """Spins → color per vertex, with deterministic conflict repair.

        Each vertex takes the first selected color of its one-hot row
        (all-unselected rows → color 0, so the decode is total).  Residual
        conflicts are then repaired greedily: the lowest-index conflicted
        vertex is recolored with the smallest color absent from its
        neighborhood; vertices whose neighborhoods exhaust all k colors are
        left as-is (``verify`` reports them).
        """
        x = np.asarray(m).reshape(self.n_vertices, self.n_colors) > 0
        colors = x.argmax(axis=1)
        edges = np.asarray(self.edges)
        if len(edges) == 0:
            return colors
        nbrs = [[] for _ in range(self.n_vertices)]
        for u, v in edges:
            nbrs[u].append(v)
            nbrs[v].append(u)
        for _ in range(self.n_vertices * self.n_colors):
            bad = edges[colors[edges[:, 0]] == colors[edges[:, 1]]]
            if len(bad) == 0:
                break
            repaired = False
            for v in sorted(set(bad.reshape(-1).tolist())):
                used = {int(colors[u]) for u in nbrs[v]}
                free = [c for c in range(self.n_colors) if c not in used]
                if free:
                    colors[v] = free[0]
                    repaired = True
                    break
            if not repaired:
                break  # no locally repairable vertex — leave for verify
        return colors

    def verify(self, solution: np.ndarray) -> bool:
        """Properness: a full assignment with no monochromatic edge."""
        colors = np.asarray(solution)
        if colors.shape != (self.n_vertices,):
            return False
        if colors.min(initial=0) < 0 or colors.max(initial=0) >= self.n_colors:
            return False
        return self.objective(colors) == 0

    def objective(self, solution: np.ndarray) -> int:
        """Number of monochromatic (conflicting) edges — 0 means proper."""
        colors = np.asarray(solution)
        if len(self.edges) == 0:
            return 0
        return int((colors[self.edges[:, 0]] == colors[self.edges[:, 1]]).sum())


def coloring_problem(
    n: int, edges: np.ndarray, k: int, *, penalty: int = 0
) -> ColoringProblem:
    """Encode k-coloring of an n-vertex graph (n·k spins).

    ``penalty`` is the one-hot constraint weight A; the default 0 picks
    ``max_degree + 1`` (> B·deg bound with B = 1, keeping couplings small).
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    deg = np.zeros(n, dtype=np.int64)
    for u, v in edges:
        deg[u] += 1
        deg[v] += 1
    A = int(penalty) if penalty else int(deg.max(initial=0)) + 1
    nk = n * k
    Q = np.zeros((nk, nk), dtype=np.int64)

    def idx(v, c):
        return v * k + c

    # one color per vertex: A·(Σ_c x_vc − 1)² = A·(Σ_c x_vc − 2·Σ x + cross)
    for v in range(n):
        for c1 in range(k):
            Q[idx(v, c1), idx(v, c1)] -= A
            for c2 in range(c1 + 1, k):
                Q[idx(v, c1), idx(v, c2)] += 2 * A
    # conflict term: one unit per monochromatic edge
    for u, v in edges:
        for c in range(k):
            Q[idx(u, c), idx(v, c)] += 1
    model, offset = qubo_to_ising(Q, name=f"color{n}x{k}")
    return ColoringProblem(
        kind="coloring",
        model=model,
        offset=offset + 4 * A * n,  # the +A·n constant of the squared term
        n_vertices=n,
        n_colors=k,
        edges=edges,
    )


def ring_coloring(
    n: int = 12, k: int = 3, *, chords: int = 0, seed: int = 0
) -> ColoringProblem:
    """An n-cycle (plus optional random chords) to k-color — smoke family."""
    if n < 3:
        raise ValueError(f"a ring needs at least 3 vertices, got {n}")
    edges = [(v, (v + 1) % n) for v in range(n)]
    if chords:
        rng = np.random.default_rng(seed)
        have = set(map(tuple, (sorted(e) for e in edges)))
        while len(edges) < n + chords:
            u, v = sorted(map(int, rng.integers(0, n, size=2)))
            if u != v and (u, v) not in have:
                have.add((u, v))
                edges.append((u, v))
    return coloring_problem(n, np.asarray(edges), k)
