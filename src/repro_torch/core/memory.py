"""Trajectory-memory models — paper Eq. (5) and Eq. (6) (port of the
analytic half of ``repro.core.memory``).

SSA stores every spin bitplane of an iteration, M = N · steps · τ bits;
HA-SSA stores only the I0 == I0max plateau, M' = N · τ bits; the ratio is
the number of plateaus (6 for Table II's I0: 1→32, β=1).
"""
from __future__ import annotations

from .schedule import n_temp_steps

__all__ = ["ssa_bits_per_iteration", "hassa_bits_per_iteration", "memory_ratio"]


def ssa_bits_per_iteration(n_spins: int, hp) -> int:
    """Eq. (5): all plateaus stored."""
    return n_spins * n_temp_steps(hp.i0_min, hp.i0_max, hp.beta_shift) * hp.tau


def hassa_bits_per_iteration(n_spins: int, hp) -> int:
    """Eq. (6): only the I0max plateau stored."""
    return n_spins * hp.tau


def memory_ratio(hp) -> int:
    """M / M' = number of temperature plateaus (6 for Table II)."""
    return n_temp_steps(hp.i0_min, hp.i0_max, hp.beta_shift)
