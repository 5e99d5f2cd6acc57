"""Problem-encoding protocol: domain problem ⇄ Ising model (DESIGN.md §9).

Every problem family in :mod:`repro_torch.problems` reduces its domain instance to
an :class:`~repro_torch.core.ising.IsingModel` and knows how to come back:

* ``encode``  — the family's ``*_problem`` constructor returns a
  :class:`ProblemEncoding` whose ``model`` the annealers (and the
  :class:`~repro_torch.serve.AnnealService`) consume unchanged;
* ``decode``  — spin vector → domain solution (always total: constraint
  violations are repaired deterministically where a canonical repair
  exists, or surfaced via ``verify`` where one does not);
* ``verify``  — feasibility check of a *decoded* solution against the
  original instance (never against the Ising energy — the whole point is
  an independent witness);
* ``objective`` — the domain objective of a feasible solution.  The
  ``minimize`` flag states the direction; :meth:`ProblemEncoding.score`
  folds it so callers can always maximize.

The Ising energy and the domain objective are tied by
``H(m) + offset = scale · objective_qubo(x)`` for the exact-QUBO families —
asserted per family in the JAX package's tests, which tests/test_torch_problems.py
holds this port to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from ..core.ising import IsingModel


@dataclasses.dataclass(frozen=True)
class ProblemEncoding:
    """Base of every family's encoding: the Ising model plus the way back.

    Subclasses add the instance data they need for decode/verify and
    override :meth:`decode`, :meth:`verify` and :meth:`objective`.
    ``offset`` is the constant of the QUBO→Ising expansion (family-specific
    meaning, documented per encoder).  The ``model`` attribute is what
    :func:`repro_torch.core.engine.normalize_problem` picks up, so an encoding can
    be passed directly to ``anneal()`` or an ``AnnealRequest``.
    """

    kind: str
    model: IsingModel
    offset: int = 0
    minimize: bool = True

    # -- the way back -----------------------------------------------------
    def decode(self, m: np.ndarray) -> Any:
        """Spin vector (N,) in {-1,+1} → domain solution."""
        raise NotImplementedError

    def verify(self, solution: Any) -> bool:
        """Feasibility of a decoded solution against the domain instance."""
        raise NotImplementedError

    def objective(self, solution: Any) -> int:
        """Domain objective of a feasible solution (direction: ``minimize``)."""
        raise NotImplementedError

    # -- conveniences shared by the service, benchmarks and tests ---------
    def score(self, solution: Any) -> int:
        """Objective folded to maximize-is-better (service-trace polarity)."""
        obj = int(self.objective(solution))
        return -obj if self.minimize else obj

    def best_feasible(
        self, best_m: np.ndarray
    ) -> Tuple[Optional[Any], Optional[int], bool]:
        """Best feasible decoded solution over a (T, N) batch of trials.

        Returns ``(solution, objective, feasible)``: the feasible solution
        with the best domain objective, or — when no trial decodes to a
        feasible solution — the first trial's decode with ``feasible=False``.
        """
        best_m = np.asarray(best_m)
        if best_m.ndim == 1:
            best_m = best_m[None]
        best: Optional[Tuple[int, Any]] = None
        for trial in best_m:
            sol = self.decode(trial)
            if not self.verify(sol):
                continue
            s = self.score(sol)
            if best is None or s > best[0]:
                best = (s, sol)
        if best is None:
            sol = self.decode(best_m[0])
            return sol, None, False
        return best[1], int(self.objective(best[1])), True


def spins_to_bits(m: np.ndarray) -> np.ndarray:
    """±1 spins → {0,1} bits under the x = (1+m)/2 convention."""
    return (np.asarray(m) > 0).astype(np.int64)
