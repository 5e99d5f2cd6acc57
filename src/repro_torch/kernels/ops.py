"""Public kernel entry points (port of ``repro.kernels.ops``).

``repro_torch.core.engine.CudaBackend`` takes its per-cycle field from
:func:`local_field` when a plateau must emit per-cycle outputs;
:func:`anneal_resident` is the host loop of whole pregenerated-noise
plateaus over kernel K4, without the plateau engine.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.rng import xorshift_init, xorshift_next_bits, xorshift_noise_cycles
from ..core.schedule import Schedule
from . import ssa_update

__all__ = ["local_field", "anneal_resident"]


def local_field(m: torch.Tensor, h: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Dense field backend of the cuda engine: h + m @ J, int32 (kernel K3)."""
    return ssa_update.local_field(m, h, J)


def anneal_resident(
    J: torch.Tensor,       # (N, N) couplings (any dtype of engine.J_DTYPES, integer-valued)
    h: torch.Tensor,       # (N,) int32
    schedule: Schedule,    # per-iteration plateau schedule
    m_shot: int,
    n_trials: int,
    *,
    n_rnd: int = 2,
    storage: str = "i0max",  # 'i0max' (HA-SSA) | 'all' (SSA)
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run a full HA-SSA schedule through the pregenerated-noise plateau
    kernel K4, on the device of ``J``.

    Returns (best_H (T,), best_m (T, N)) as numpy arrays.  Host Python
    drives the plateaus (m_shot × steps launches of K4), each over τ cycles
    of xorshift noise drawn before its launch; all cycle-level work is in
    the kernel.
    """
    dev = J.device
    N = J.shape[0]
    i0_values = np.sort(np.unique(schedule.i0_per_cycle))  # ascending
    i0_max = int(i0_values[-1])

    state = xorshift_init(seed, (n_trials, N), dev)
    state, r0 = xorshift_next_bits(state)
    m = r0.to(torch.float32)
    itanh = torch.where(m > 0, 0, -1).to(torch.int32)
    best_H = torch.full((n_trials,), 2**30, dtype=torch.int32, device=dev)
    best_m = m.to(torch.int8)
    h = h.to(torch.int32)

    for _ in range(m_shot):
        for i0 in i0_values:
            eligible = storage == "all" or int(i0) == i0_max
            state, noise = xorshift_noise_cycles(state, schedule.tau)
            m, itanh, best_H, best_m = ssa_update.ssa_plateau(
                m, itanh, J, h, noise, int(i0), best_H, best_m,
                n_rnd=n_rnd, eligible=eligible,
            )
    return best_H.cpu().numpy(), best_m.cpu().numpy()
