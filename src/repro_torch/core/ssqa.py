"""Stochastic simulated quantum annealing, SSQA (port of ``repro.core.ssqa``;
arXiv:2302.12454).

The path-integral form of a transverse-field Ising model maps it onto R
coupled classical replicas, and the p-bit update gains one term, the
nearest-neighbour replica coupling:

    I_i^k(t+1) = h_i + Σ_j J_ij m_j^k + J⊥(t)·(m_i^{k-1} + m_i^{k+1})
                 + n_rnd·r + Itanh_i^k(t)

over a closed ring (k ± 1 mod R), with J⊥(t) rising as the transverse
field anneals.  Everything else is SSA's, so the plateau engine runs it:

* the replica axis is the trial axis: ``n_trials`` holds
  ``n_trials/n_replicas`` rings of ``n_replicas`` consecutive replicas;
* the J⊥ ramp rides the schedule (:func:`~repro_torch.core.schedule.
  ssqa_schedule`), split into plateaus with the I0 ramp;
* the coupling enters the update field only: best tracking and the energy
  traces keep the classical per-replica energy.

On ``backend='cuda'`` SSQA plateaus run the ring modes of K1 and K2.
Under ``partition='spin'`` the rings stay whole on every rank (they live
on the trial axis; the spin axis is what is sharded), so the coupling
needs no collective of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from .autotune import resolve_hyperparams
from .ising import IsingModel, MaxCutProblem
from .schedule import Schedule, ssqa_schedule
from .ssa import AnnealResult, SSAHyperParams, anneal

__all__ = ["SSQAHyperParams", "anneal_ssqa"]


@dataclasses.dataclass(frozen=True)
class SSQAHyperParams(SSAHyperParams):
    """SSA's Table II knobs plus the Trotter dimension.

    ``n_trials`` must be a multiple of ``n_replicas``; ``jperp_max`` is the
    integer J⊥ of the coldest plateau, reached by a linear ramp from 0.
    """

    n_trials: int = 96
    n_replicas: int = 8
    jperp_max: int = 4

    def __post_init__(self):
        if self.n_replicas < 2:
            raise ValueError(f"n_replicas must be >= 2, got {self.n_replicas}")
        if self.n_trials % self.n_replicas:
            raise ValueError(
                f"n_trials={self.n_trials} must be divisible by "
                f"n_replicas={self.n_replicas} (whole Trotter rings)"
            )
        if self.jperp_max < 0:
            raise ValueError(f"jperp_max must be >= 0, got {self.jperp_max}")

    def schedule(self, kind: str = "hassa") -> Schedule:
        # 'hassa' and 'ssqa' both name the shift-based ramp with J⊥ attached,
        # so anneal()'s default schedule_kind works unchanged.
        if kind in ("hassa", "ssqa"):
            return ssqa_schedule(self.i0_min, self.i0_max, self.tau, self.beta_shift,
                                 jperp_max=self.jperp_max)
        raise ValueError(f"SSQA supports schedule_kind 'hassa'/'ssqa', got {kind!r}")


def anneal_ssqa(
    problem: Union[MaxCutProblem, IsingModel],
    hp: Union[SSQAHyperParams, str] = SSQAHyperParams(),
    seed: int = 0,
    *,
    auto_base: Optional[SSQAHyperParams] = None,
    **kw,
) -> AnnealResult:
    """:func:`~repro_torch.core.ssa.anneal` with SSQA hyper-parameters.

    ``hp='auto'`` autotunes the energy-scale knobs, the ring depth and
    J⊥max from the instance (:mod:`repro_torch.core.autotune`), with the
    budget knobs of ``auto_base`` (default ``SSQAHyperParams()``).
    """
    if isinstance(hp, str):
        hp, _ = resolve_hyperparams(hp, problem, base=auto_base or SSQAHyperParams(),
                                    algo="ssqa")
    if not isinstance(hp, SSQAHyperParams):
        raise TypeError(f"anneal_ssqa needs SSQAHyperParams, got {type(hp)}")
    return anneal(problem, hp, seed, **kw)
