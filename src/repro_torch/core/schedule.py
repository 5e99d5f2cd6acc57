"""Pseudo-inverse temperature schedules (port of ``repro.core.schedule``).

SSA (Eq. 3):     I0(t+τ) = I0(t) / β          with real β < 1
HA-SSA (Eq. 4):  I0(t+τ) = 2^β · I0(t)        with integer β (a shift)

Both raise I0 from I0min to I0max in geometric steps held for τ cycles;
with β_ssa = 2^{-β_hassa} the two are identical.  Pure numpy.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = ["Schedule", "hassa_schedule", "ssa_schedule", "n_temp_steps"]


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
    """

    i0_per_cycle: np.ndarray
    tau: int
    steps: int
    store_mask: np.ndarray

    @property
    def cycles_per_iter(self) -> int:
        return int(self.i0_per_cycle.shape[0])

    def signature(self) -> str:
        """Stable identity of the per-cycle program: a hash of
        (i0_per_cycle, store_mask, tau), equal to the JAX package's."""
        payload = (
            "Schedule/v1",
            tuple(int(x) for x in np.asarray(self.i0_per_cycle)),
            tuple(bool(x) for x in np.asarray(self.store_mask)),
            int(self.tau),
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
