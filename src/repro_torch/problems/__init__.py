"""repro_torch.problems — the scenario-diverse problem frontend (DESIGN.md §9).

Each family reduces a domain instance to an Ising model and carries the way
back (decode → domain solution, verify → feasibility, objective → domain
cost), so the annealers and the :class:`~repro_torch.serve.AnnealService` consume
every family through one interface:

  qubo       — generic xᵀQx minimization (unconstrained)
  mis        — maximum independent set (penalty reduction + repair decode)
  coloring   — graph k-coloring (one-hot reduction)
  partition  — number partitioning (fully-connected integer Ising)

``FAMILIES`` maps the kind names to demo-instance factories sized for
smoke runs and benchmarks; :func:`make_demo` is the launcher/benchmark
entry.  Max-Cut stays on its dedicated
:class:`~repro_torch.core.ising.MaxCutProblem` path (it *is* the Ising model).
"""

from typing import Callable, Dict

from .base import ProblemEncoding, spins_to_bits  # noqa: F401
from .coloring import ColoringProblem, coloring_problem, ring_coloring  # noqa: F401
from .mis import MISProblem, mis_problem, random_mis_graph  # noqa: F401
from .partition import (  # noqa: F401
    PartitionProblem,
    partition_problem,
    random_partition,
)
from .qubo import QUBOProblem, qubo_problem, qubo_to_ising, random_qubo  # noqa: F401

__all__ = [
    "ProblemEncoding",
    "spins_to_bits",
    "QUBOProblem",
    "qubo_problem",
    "qubo_to_ising",
    "random_qubo",
    "MISProblem",
    "mis_problem",
    "random_mis_graph",
    "ColoringProblem",
    "coloring_problem",
    "ring_coloring",
    "PartitionProblem",
    "partition_problem",
    "random_partition",
    "FAMILIES",
    "make_demo",
]

# kind → demo-instance factory (n, seed) → ProblemEncoding.  The sizes the
# factories default to are smoke-scale; benchmarks pass their own n.
FAMILIES: Dict[str, Callable[..., ProblemEncoding]] = {
    "qubo": lambda n=32, seed=0: random_qubo(n, seed=seed),
    "mis": lambda n=48, seed=0: random_mis_graph(n, seed=seed),
    "coloring": lambda n=36, seed=0: ring_coloring(
        max(n // 3, 3), 3, chords=n // 12, seed=seed
    ),
    "partition": lambda n=24, seed=0: random_partition(n, seed=seed),
}


def make_demo(kind: str, n: int = 0, seed: int = 0) -> ProblemEncoding:
    """Build a demo instance of a problem family (launcher/benchmark entry)."""
    try:
        factory = FAMILIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown problem kind {kind!r}; known: {sorted(FAMILIES)}"
        ) from None
    return factory(n, seed=seed) if n else factory(seed=seed)
