"""Beyond-paper integration: HA-SSA as the MoE expert-placement optimizer.

Expert parallelism shards experts across the `model` mesh axis; each token's
top-k dispatch then crosses devices (all-to-all).  Two effects determine the
collective cost:

  * **co-activation** — experts that fire together for the same token should
    be co-located (one dispatch hop instead of two);
  * **load balance** — popular experts should spread across devices (the
    all-to-all is bottlenecked by the hottest device).

Balanced-min-cut of the co-activation graph is NP-hard (it IS weighted
MAX-CUT's complement) — exactly the workload HA-SSA solves.  We embed it as
an Ising model:

    J_ij = round(σ·coact_ij) − λ·round(σ·load_i·load_j)

(same-spin ⇒ same device; the load term is the expansion of the balance
penalty (Σ_i load_i·m_i)²) and anneal with the paper's algorithm.  D > 2
devices are handled by recursive bisection, each level one HA-SSA run.

This is the paper's technique as a feature of the training framework
(DESIGN.md §3); the JAX package's ``launch.train --placement ssa`` applies it
to the MoE archs, and this port runs the same placement on its own
``anneal()`` (the LM substrate itself is not ported).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .config import SolverConfig
from .ising import IsingModel
from .ssa import SSAHyperParams, anneal

__all__ = [
    "coactivation_stats",
    "placement_ising",
    "expert_placement",
    "traffic_cost",
    "PlacementResult",
]


def coactivation_stats(routing: np.ndarray, n_experts: int) -> Tuple[np.ndarray, np.ndarray]:
    """(coact (E,E), load (E,)) from observed top-k routing decisions.

    routing: (n_tokens, top_k) int expert ids.
    """
    E = n_experts
    coact = np.zeros((E, E), dtype=np.int64)
    load = np.zeros(E, dtype=np.int64)
    for row in routing:
        u = np.unique(row)
        load[u] += 1
        for a in range(len(u)):
            for b in range(a + 1, len(u)):
                coact[u[a], u[b]] += 1
                coact[u[b], u[a]] += 1
    return coact, load


def placement_ising(
    coact: np.ndarray,
    load: np.ndarray,
    lam: float = 1.0,
    scale: float = 1.0,
) -> IsingModel:
    """Ising embedding of balanced min-cut placement (integer couplings)."""
    E = coact.shape[0]
    loadf = load.astype(np.float64)
    loadf = loadf / max(loadf.mean(), 1e-9)
    bal = np.outer(loadf, loadf)
    J = scale * coact.astype(np.float64) / max(coact.max(initial=1), 1) * 16.0
    J = J - lam * bal * 16.0
    J = np.round(J).astype(np.int64)
    np.fill_diagonal(J, 0)
    J = np.triu(J, 1) + np.triu(J, 1).T
    return IsingModel.from_dense(J, name="expert-placement")


@dataclasses.dataclass
class PlacementResult:
    assignment: np.ndarray  # (E,) device ids
    cost: float
    baseline_cost: float

    @property
    def improvement(self) -> float:
        return (self.baseline_cost - self.cost) / max(self.baseline_cost, 1e-9)


def traffic_cost(assignment: np.ndarray, coact: np.ndarray, load: np.ndarray) -> float:
    """Modeled all-to-all cost: cross-device co-activation + hottest-device load.

    cost = Σ_{i<j, dev_i≠dev_j} coact_ij  +  λ_imb · max_dev(Σ load) · D
    """
    E = len(assignment)
    cross = 0.0
    for i in range(E):
        for j in range(i + 1, E):
            if assignment[i] != assignment[j]:
                cross += coact[i, j]
    n_dev = int(assignment.max()) + 1
    per_dev = np.zeros(n_dev)
    for i in range(E):
        per_dev[assignment[i]] += load[i]
    imbalance = per_dev.max() * n_dev - load.sum()
    return float(cross + imbalance * coact.max(initial=1) / max(load.mean(), 1e-9))


def _bisect(coact, load, idx, hp, seed, lam, device):
    model = placement_ising(coact[np.ix_(idx, idx)], load[idx], lam=lam)
    res = anneal(model, hp, seed=seed, config=SolverConfig(noise="xorshift"),
                 track_energy=False, device=device)
    best = res.best_m[int(np.argmin(res.best_energy))]
    left = idx[best > 0]
    right = idx[best <= 0]
    if len(left) == 0 or len(right) == 0:  # degenerate split: force halves
        half = len(idx) // 2
        left, right = idx[:half], idx[half:]
    return left, right


def expert_placement(
    coact: np.ndarray,
    load: np.ndarray,
    n_devices: int,
    hp: Optional[SSAHyperParams] = None,
    seed: int = 0,
    lam: float = 1.0,
    *,
    device=None,
) -> PlacementResult:
    """Recursive-bisection placement of E experts onto n_devices (power of 2).

    Each bisection is one ``anneal()`` on the sparse backend with xorshift
    noise, as in the JAX package, on ``device`` (``cuda`` unless the caller
    passes ``device='cpu'``).
    """
    E = coact.shape[0]
    assert n_devices & (n_devices - 1) == 0, "n_devices must be a power of 2"
    hp = hp or SSAHyperParams(n_trials=8, m_shot=10, tau=50, i0_min=1, i0_max=16)
    groups = [np.arange(E)]
    level = 0
    while len(groups) < n_devices:
        new_groups = []
        for gi, g in enumerate(groups):
            l, r = _bisect(coact, load, g, hp, seed + 31 * level + gi, lam, device)
            new_groups += [l, r]
        groups = new_groups
        level += 1
    assignment = np.zeros(E, dtype=np.int64)
    for d, g in enumerate(groups):
        assignment[g] = d
    baseline = np.arange(E) % n_devices  # naive round-robin
    return PlacementResult(
        assignment=assignment,
        cost=traffic_cost(assignment, coact, load),
        baseline_cost=traffic_cost(baseline, coact, load),
    )
