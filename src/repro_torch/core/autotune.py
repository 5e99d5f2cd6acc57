"""Local-energy-distribution hyper-parameter determination (port of
``repro.core.autotune``; arXiv:2304.11839).

Table II's settings (n_rnd = 2, I0: 1→32) suit ±1-weight MAX-CUT; on
integer-weight models they fail, because both knobs scale with the local
fields z_i = h_i + Σ_j J_ij m_j.  This module measures those fields over S
seeded random states (numpy on the host, no device) and derives:

* n_rnd = round(σ), clipped to [1, 2^16] — noise on the couplings' scale;
* I0max = next_pow2(8·max|z|), clipped to [8, 2^20]; I0min = 1;
* τ rescaled so one iteration keeps the base's cycle budget (steps·τ),
  at least 8;
* for an SSQA base (one with ``n_replicas``): R = next_pow2(round(4σ)),
  clipped to [2, 16], J⊥max = round(2σ), clipped to [1, 16], and
  ``n_trials`` rounded up to whole rings.

On the G11 twin (σ = 2, max|z| = 4) this gives Table II and the SSQA
defaults (R = 8, J⊥max = 4).  Identical (model, base, n_samples, seed)
give identical results, equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .ising import IsingModel
from .schedule import n_temp_steps
from .ssa import SSAHyperParams

__all__ = [
    "AutotuneReport",
    "sample_local_fields",
    "autotune_hyperparams",
    "resolve_hyperparams",
]

# Output bounds (module docstring).
N_RND_MAX = 1 << 16
I0_MAX_FLOOR = 8
I0_MAX_CEIL = 1 << 20
TAU_FLOOR = 8
N_REPLICAS_MIN = 2
N_REPLICAS_MAX = 16
JPERP_MAX_CEIL = 16


@dataclasses.dataclass(frozen=True)
class AutotuneReport:
    """What the determination measured and decided."""

    sigma: float          # std of the sampled local fields
    z_max: int            # max |local field| over the samples
    n_samples: int
    seed: int
    n_rnd: int
    i0_min: int
    i0_max: int
    tau: int
    # SSQA bases only (None for classical ones).
    n_replicas: Optional[int] = None
    jperp_max: Optional[int] = None


def sample_local_fields(model: IsingModel, n_samples: int = 64, seed: int = 0) -> np.ndarray:
    """(S, N) int64 local fields of S seeded random ±1 states, over the
    padded adjacency, chunked over samples so the (chunk, N, deg) gather
    stays near 0.5 GB."""
    n_samples = int(n_samples)
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, size=(n_samples, model.n)) * 2 - 1
    nbr_idx = np.asarray(model.nbr_idx)
    nbr_w = np.asarray(model.nbr_w, dtype=np.int64)
    h = np.asarray(model.h, np.int64)
    chunk = max(1, int(2**26 // max(model.n * model.max_degree, 1)))
    out = np.empty((n_samples, model.n), dtype=np.int64)
    for s0 in range(0, n_samples, chunk):
        neigh = m[s0:s0 + chunk][:, nbr_idx]  # (chunk, N, D)
        out[s0:s0 + chunk] = h + (nbr_w * neigh).sum(axis=-1)
    return out


def _next_pow2(v: int) -> int:
    v = int(v)
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


def autotune_hyperparams(
    model: IsingModel,
    base: Optional[SSAHyperParams] = None,
    *,
    n_samples: int = 64,
    seed: int = 0,
) -> Tuple[SSAHyperParams, AutotuneReport]:
    """Per-instance hyper-parameters from the local-field sample.

    ``base`` gives the budget knobs (n_trials, m_shot, the per-iteration
    cycle budget tau·steps, beta_shift) and keeps its type
    (``dataclasses.replace``); the energy-scale knobs and τ are derived
    here, and for an SSQA base the ring depth and J⊥ ceiling too.
    """
    base = base if base is not None else SSAHyperParams()
    z = sample_local_fields(model, n_samples=n_samples, seed=seed)
    sigma = float(z.std())
    z_max = int(np.abs(z).max(initial=1))

    n_rnd = int(np.clip(round(sigma), 1, N_RND_MAX))
    i0_max = int(np.clip(_next_pow2(8 * z_max), I0_MAX_FLOOR, I0_MAX_CEIL))
    i0_min = 1
    steps_base = n_temp_steps(base.i0_min, base.i0_max, base.beta_shift)
    steps = n_temp_steps(i0_min, i0_max, base.beta_shift)
    tau = int(np.clip(round(steps_base * base.tau / steps), TAU_FLOOR, None))

    updates = dict(n_rnd=n_rnd, i0_min=i0_min, i0_max=i0_max, tau=tau)
    n_replicas = jperp_max = None
    if hasattr(base, "n_replicas"):
        n_replicas = int(np.clip(_next_pow2(max(2, round(4 * sigma))),
                                 N_REPLICAS_MIN, N_REPLICAS_MAX))
        jperp_max = int(np.clip(round(2 * sigma), 1, JPERP_MAX_CEIL))
        updates.update(n_replicas=n_replicas, jperp_max=jperp_max,
                       n_trials=-(-base.n_trials // n_replicas) * n_replicas)
    hp = dataclasses.replace(base, **updates)
    report = AutotuneReport(
        sigma=sigma, z_max=z_max, n_samples=int(n_samples), seed=int(seed),
        n_rnd=n_rnd, i0_min=i0_min, i0_max=i0_max, tau=tau,
        n_replicas=n_replicas, jperp_max=jperp_max,
    )
    return hp, report


def resolve_hyperparams(
    hp,
    model: IsingModel,
    *,
    base: Optional[SSAHyperParams] = None,
    seed: int = 0,
    algo: Optional[str] = None,
) -> Tuple[SSAHyperParams, Optional[AutotuneReport]]:
    """``hp='auto'`` → :func:`autotune_hyperparams` on the model (a
    ``MaxCutProblem`` is converted); a hyper-parameter object passes
    through.  Without ``base``, ``algo='ssqa'`` starts from
    :class:`~repro_torch.core.ssqa.SSQAHyperParams`, anything else from
    :class:`SSAHyperParams`.  The draw is seeded apart from the anneal, so
    one problem always resolves to the same hyper-parameters."""
    if isinstance(hp, str):
        if hp != "auto":
            raise ValueError(f"unknown hyperparameter mode {hp!r}; use 'auto'")
        if base is None and algo == "ssqa":
            from .ssqa import SSQAHyperParams  # ssqa imports this module

            base = SSQAHyperParams()
        if hasattr(model, "to_ising"):
            model = model.to_ising()
        return autotune_hyperparams(model, base, seed=seed)
    return hp, None
