"""Pseudo-inverse temperature schedules (port of ``repro.core.schedule``).

SSA (Eq. 3):     I0(t+τ) = I0(t) / β          with real β < 1
HA-SSA (Eq. 4):  I0(t+τ) = 2^β · I0(t)        with integer β (a shift)

Both raise I0 from I0min to I0max in geometric steps held for τ cycles;
with β_ssa = 2^{-β_hassa} the two are identical.  Pure numpy.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

__all__ = ["Schedule", "hassa_schedule", "ssa_schedule", "ssqa_schedule", "n_temp_steps"]


def n_temp_steps(i0_min: int, i0_max: int, beta_shift: int = 1) -> int:
    """Number of distinct temperature plateaus in one iteration (6 for 1→32)."""
    if i0_min <= 0 or i0_max < i0_min:
        raise ValueError("need 0 < i0_min <= i0_max")
    steps = 1
    v = i0_min
    while v < i0_max:
        v <<= beta_shift
        steps += 1
    return steps


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A per-cycle I0 schedule for one iteration.

    Attributes:
      i0_per_cycle: int32[cycles_per_iter] pseudo-inverse temperature per cycle.
      tau: plateau length in cycles.
      steps: number of plateaus.
      store_mask: bool[cycles_per_iter] — True where HA-SSA asserts the
        storage write-enable (I0 == I0max).
      jperp_per_cycle: optional int32[cycles_per_iter] Trotter-replica
        coupling J⊥(t) of SSQA; ``None`` for classical schedules, whose
        signature stays the v1 payload.
    """

    i0_per_cycle: np.ndarray
    tau: int
    steps: int
    store_mask: np.ndarray
    jperp_per_cycle: Optional[np.ndarray] = None

    @property
    def cycles_per_iter(self) -> int:
        return int(self.i0_per_cycle.shape[0])

    def signature(self) -> str:
        """Stable identity of the per-cycle program: a hash of
        (i0_per_cycle, store_mask, tau), and of the J⊥ ramp under a distinct
        version tag when there is one; equal to the JAX package's."""
        payload = (
            "Schedule/v1",
            tuple(int(x) for x in np.asarray(self.i0_per_cycle)),
            tuple(bool(x) for x in np.asarray(self.store_mask)),
            int(self.tau),
        )
        if self.jperp_per_cycle is not None:
            payload = (
                "Schedule/v2-ssqa",
                payload,
                tuple(int(x) for x in np.asarray(self.jperp_per_cycle)),
            )
        return hashlib.sha256(repr(payload).encode()).hexdigest()[:16]


def _plateau_schedule(plateaus, i0_max: int, tau: int) -> Schedule:
    plateaus = np.asarray(plateaus, dtype=np.int32)
    i0 = np.repeat(plateaus, tau)
    mask = np.repeat(plateaus == i0_max, tau)
    return Schedule(i0_per_cycle=i0, tau=tau, steps=len(plateaus), store_mask=mask)


def hassa_schedule(i0_min: int, i0_max: int, tau: int, beta_shift: int = 1) -> Schedule:
    """Eq. (4): integer-only, shift-based plateau sequence."""
    if beta_shift < 1:
        raise ValueError("beta_shift must be >= 1")
    plateaus = []
    v = int(i0_min)
    while True:
        plateaus.append(min(v, int(i0_max)))
        if plateaus[-1] >= i0_max:
            break
        v <<= beta_shift
    return _plateau_schedule(plateaus, i0_max, tau)


def ssa_schedule(i0_min: int, i0_max: int, tau: int, beta: float = 0.5) -> Schedule:
    """Eq. (3): real-β division-based plateau sequence (integer plateaus)."""
    if not (0.0 < beta < 1.0):
        raise ValueError("ssa beta must be in (0,1)")
    plateaus = []
    v = float(i0_min)
    while True:
        plateaus.append(min(int(round(v)), int(i0_max)))
        if plateaus[-1] >= i0_max:
            break
        v = v / beta
    return _plateau_schedule(plateaus, i0_max, tau)


def ssqa_schedule(i0_min: int, i0_max: int, tau: int, beta_shift: int = 1, *,
                  jperp_max: int = 4) -> Schedule:
    """SSQA (arXiv:2302.12454): HA-SSA's I0 ramp plus the integer replica
    coupling J⊥, 0 at the hottest plateau rising linearly to ``jperp_max``
    at the coldest.  Plateau s gets ``round(jperp_max·s/(steps−1))`` with
    Python's round (half to even), as the JAX package computes it."""
    base = hassa_schedule(i0_min, i0_max, tau, beta_shift)
    steps = base.steps
    if steps == 1:
        per_plateau = [int(jperp_max)]
    else:
        per_plateau = [round(int(jperp_max) * s / (steps - 1)) for s in range(steps)]
    return dataclasses.replace(
        base, jperp_per_cycle=np.repeat(np.asarray(per_plateau, dtype=np.int32), tau))
