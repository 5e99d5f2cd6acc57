"""Further combinatorial problems as Ising models (paper Sec. VI-B).

The paper argues HA-SSA extends beyond ±1 MAX-CUT to problems with integer
weights/biases and denser connectivity (TSP, graph isomorphism in [6]).
This module provides QUBO→Ising encoders for three such families, each with
a decoder and a feasibility/cost evaluator, so the annealers (ssa/sa/pt)
run on them unchanged:

  * TSP         — permutation one-hot encoding, integer distances
  * number partitioning — the classic fully-connected integer-weight Ising
  * graph isomorphism — permutation-matrix encoding (paper's GI workload)

QUBO x∈{0,1}ⁿ with x = (1+m)/2 maps to Ising via
  J_ij = -Q_ij/2 (i≠j),  h_i = -(Q_ii/2 + Σ_{j≠i} Q_ij/4)·2 ... we keep all
couplings integral by scaling Q by 4 up front (documented per encoder).

The production problem frontend — encodings with decode/verify carried as
one object, servable through :class:`repro_torch.serve.AnnealService` — lives in
:mod:`repro_torch.problems` (DESIGN.md §9); this module keeps the original
Sec. VI-B demonstrations (TSP, GI) and the legacy tuple-style entries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .ising import IsingModel

__all__ = [
    "qubo_to_ising",
    "TSPProblem",
    "tsp_problem",
    "decode_tsp",
    "tsp_tour_length",
    "partition_problem",
    "decode_partition",
    "gi_problem",
    "decode_gi",
]


def suggest_hyperparams(model: IsingModel, n_trials: int = 16, m_shot: int = 20):
    """Scale n_rnd / I0max to the coupling magnitude (integer-weight problems).

    The paper's Table II is tuned for ±1 MAX-CUT; for integer weights the
    fluctuation scale must track |J| (empirically n_rnd ≈ |J|max/4 and
    I0max ≈ 8·|J|max keep the accept/escape balance — validated on TSP,
    partitioning, and GI in tests/test_problems.py).

    This is the coarse *hand* heuristic; the measured, per-instance
    determination is :func:`repro_torch.core.autotune.autotune_hyperparams`.
    """
    from .ssa import SSAHyperParams

    jmax = int(np.abs(model.dense_J()).max(initial=1))
    i0_max = 1 << max(int(np.ceil(np.log2(8 * jmax))), 3)
    return SSAHyperParams(
        n_trials=n_trials, m_shot=m_shot, tau=50,
        n_rnd=max(jmax // 4, 2), i0_min=1, i0_max=i0_max,
    )


# Canonical home of the QUBO→Ising expansion is the problem frontend
# (repro_torch.problems.qubo); re-exported here for the Sec. VI-B callers.
from ..problems.qubo import qubo_to_ising  # noqa: E402, F401


# ---------------------------------------------------------------------------
# TSP (paper Sec. VI-B)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TSPProblem:
    dist: np.ndarray      # (C, C) integer distances
    model: IsingModel
    offset: int
    penalty: int

    @property
    def n_cities(self) -> int:
        return self.dist.shape[0]


def tsp_problem(dist: np.ndarray, penalty: Optional[int] = None) -> TSPProblem:
    """One-hot encoding: x[c, t] = city c visited at time t (n² spins).

    QUBO = A·(constraint violations) + tour length, A > max tour edge · 2.
    """
    dist = np.asarray(dist, dtype=np.int64)
    C = dist.shape[0]
    A = penalty if penalty is not None else int(dist.max() * 2 * C)
    n = C * C
    Q = np.zeros((n, n), dtype=np.int64)

    def idx(c, t):
        return c * C + t

    # each city exactly once: A(Σ_t x_ct − 1)²  → expand
    for c in range(C):
        for t1 in range(C):
            Q[idx(c, t1), idx(c, t1)] -= A
            for t2 in range(C):
                if t1 != t2:
                    Q[idx(c, t1), idx(c, t2)] += A
    # each time exactly one city
    for t in range(C):
        for c1 in range(C):
            Q[idx(c1, t), idx(c1, t)] -= A
            for c2 in range(C):
                if c1 != c2:
                    Q[idx(c1, t), idx(c2, t)] += A
    # tour length: d(c1,c2) x_{c1,t} x_{c2,t+1}
    for t in range(C):
        tn = (t + 1) % C
        for c1 in range(C):
            for c2 in range(C):
                if c1 != c2:
                    Q[idx(c1, t), idx(c2, tn)] += dist[c1, c2]
    model, offset = qubo_to_ising(Q, name=f"tsp{C}")
    return TSPProblem(dist=dist, model=model, offset=offset + 8 * A * C // 4, penalty=A)


def decode_tsp(p: TSPProblem, m: np.ndarray) -> Optional[np.ndarray]:
    """Spin vector → tour (city per time) or None if constraints violated."""
    C = p.n_cities
    x = (np.asarray(m).reshape(C, C) > 0)
    if not (x.sum(axis=0) == 1).all() or not (x.sum(axis=1) == 1).all():
        return None
    return x.argmax(axis=0)  # city at each time


def tsp_tour_length(p: TSPProblem, tour: np.ndarray) -> int:
    return int(sum(p.dist[tour[t], tour[(t + 1) % len(tour)]] for t in range(len(tour))))


# ---------------------------------------------------------------------------
# Number partitioning (integer weights, fully connected)
# ---------------------------------------------------------------------------
def partition_problem(values: np.ndarray) -> Tuple[IsingModel, np.ndarray]:
    """Minimize (Σ v_i m_i)²: J_ij = -2 v_i v_j, h = 0 (up to constant).

    Legacy tuple-returning entry; the encoded form lives in
    :func:`repro_torch.problems.partition.partition_problem`.
    """
    from ..problems.partition import partition_problem as _encode

    p = _encode(values)
    return p.model, p.values


def decode_partition(values: np.ndarray, m: np.ndarray) -> int:
    """|sum(A) − sum(B)| for the two subsets."""
    v = np.asarray(values, dtype=np.int64)
    return int(abs((v * np.asarray(m)).sum()))


# ---------------------------------------------------------------------------
# Graph isomorphism (paper's GI workload from [6])
# ---------------------------------------------------------------------------
def gi_problem(A1: np.ndarray, A2: np.ndarray, penalty: int = 4):
    """x[u, v] = vertex u of G1 maps to v of G2 (n² spins).

    QUBO: permutation constraints + edge-mismatch penalties; ground state 0
    iff the graphs are isomorphic.
    """
    A1 = np.asarray(A1, dtype=np.int64)
    A2 = np.asarray(A2, dtype=np.int64)
    n = A1.shape[0]
    assert A2.shape[0] == n
    N = n * n
    Q = np.zeros((N, N), dtype=np.int64)

    def idx(u, v):
        return u * n + v

    P = penalty
    for u in range(n):  # each u maps to exactly one v
        for v1 in range(n):
            Q[idx(u, v1), idx(u, v1)] -= P
            for v2 in range(n):
                if v1 != v2:
                    Q[idx(u, v1), idx(u, v2)] += P
    for v in range(n):  # each v is image of exactly one u
        for u1 in range(n):
            Q[idx(u1, v), idx(u1, v)] -= P
            for u2 in range(n):
                if u1 != u2:
                    Q[idx(u1, v), idx(u2, v)] += P
    # edge mismatch: (u1,u2)∈E1 but (v1,v2)∉E2 (and vice versa)
    for u1 in range(n):
        for u2 in range(n):
            if u1 == u2:
                continue
            for v1 in range(n):
                for v2 in range(n):
                    if v1 == v2:
                        continue
                    if A1[u1, u2] != A2[v1, v2]:
                        Q[idx(u1, v1), idx(u2, v2)] += 1
    model, offset = qubo_to_ising(Q, name=f"gi{n}")
    return model, offset


def decode_gi(n: int, m: np.ndarray) -> Optional[np.ndarray]:
    x = (np.asarray(m).reshape(n, n) > 0)
    if not (x.sum(axis=0) == 1).all() or not (x.sum(axis=1) == 1).all():
        return None
    return x.argmax(axis=1)  # mapping u → v
