"""Parallel-tempering baseline and PT-SSA (port of ``repro.core.pt``).

**PT** (:func:`anneal_pt`, paper Sec. V-C, Table VII): R replicas run
single-spin Metropolis at a fixed geometric ladder of temperatures; every
``swap_interval`` cycles adjacent replicas of one parity attempt a
configuration exchange with probability min(1, exp((1/T_a - 1/T_b)(H_a -
H_b))).

**PT-SSA** (:func:`anneal_pt_ssa`): the replica ladder on the plateau
engine's trial axis.  R replicas run the p-bit update (Eq. 2a–2c) at a
fixed per-replica I0 (a (R, 1) I0 column clamps Eq. 2b), and a swap phase
between plateaus exchanges (m, Itanh) of adjacent rungs under β_k =
beta_scale · I0_k.  It runs the scan path of the sparse and dense backends
(:func:`repro_torch.core.engine.run_plateau_scan`): the CUDA plateau
kernels take a scalar I0, as the JAX package's Pallas kernels do, so
``backend='cuda'`` raises.

Neither runs a CUDA kernel of its own: the JAX package's PT is a
``lax.scan`` of gathers and its PT-SSA the plateau scan, no Pallas
kernel.  Randomness is ``jax.random``'s, drawn as the JAX package draws
it (the keys are a tree of splits, computed all at once), and every
acceptance test uses XLA's float32 logarithm
(:func:`repro_torch.core.xla_math.xla_log`), so results are bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from .engine import (
    BaseResult,
    EngineState,
    energy_from_field,
    finalize_cut,
    make_backend,
    normalize_problem,
    resolve_device,
    run_plateau_scan,
)
from .ising import IsingModel, MaxCutProblem
from .rng import PRNGKey, bernoulli, randint, split, split_keys, uniform
from .sa import _sa_energy
from .xla_math import xla_log

__all__ = [
    "PTHyperParams",
    "PTResult",
    "anneal_pt",
    "PTSSAHyperParams",
    "PTSSAResult",
    "anneal_pt_ssa",
    "pt_ssa_rounds",
    "pt_ssa_swap_keys",
]

# Rounds whose draws are made in one pass.
_ROUND_BLOCK = 256


def _swap_perm(do_swap: torch.Tensor, R: int) -> torch.Tensor:
    """Permutation (..., R) exchanging rungs (k, k+1) where do_swap[..., k].

    Accepted pairs share one parity, so an index is in at most one accepted
    swap: as the lower member (takes from above) or the upper one (takes
    from below).
    """
    idx = torch.arange(R, device=do_swap.device)
    lead = do_swap.shape[:-1]
    no = torch.zeros(lead + (1,), dtype=torch.bool, device=do_swap.device)
    take_above = torch.cat([do_swap, no], dim=-1)   # idx k   ← k+1
    take_below = torch.cat([no, do_swap], dim=-1)   # idx k+1 ← k
    return torch.where(take_above, idx + 1, torch.where(take_below, idx - 1, idx))


def _permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (..., R, N) reordered by ``perm`` (..., R)."""
    return torch.take_along_dim(x, perm[..., None], dim=-2)


@dataclasses.dataclass(frozen=True)
class PTHyperParams:
    n_replicas: int = 8
    n_cycles: int = 90_000
    swap_interval: int = 100
    t_min: float = 0.2
    t_max: float = 10.0


@dataclasses.dataclass
class PTResult(BaseResult):
    """PT reports one chain-best; scalars, but the BaseResult contract holds."""

    hp: PTHyperParams


def _pt_draws(keys: np.ndarray, n_replicas: int, n: int, swap_interval: int, device):
    """The draws of a block of rounds from their keys (K, 2): proposal
    sites (K, S, R), log-uniforms of the Metropolis tests (K, S, R) and of
    the swap (K, R-1).  Round key → ``split(·, S + 1)``; the first S are
    cycle keys → ``k_site, k_acc = split(·)``; the last is the swap key."""
    R = int(n_replicas)
    ks = split_keys(torch.as_tensor(keys, device=device), swap_interval + 1)
    cyc = split_keys(ks[:, :-1], 2)                       # (K, S, 2, 2)
    sites = randint(cyc[:, :, 0], (R,), 0, n, device=device).to(torch.int64)
    log_acc = xla_log(uniform(cyc[:, :, 1], (R,), minval=1e-12, device=device))
    log_swap = xla_log(uniform(ks[:, -1], (R - 1,), minval=1e-12, device=device))
    return sites, log_acc, log_swap


def anneal_pt(
    problem: Union[MaxCutProblem, IsingModel],
    hp: PTHyperParams = PTHyperParams(),
    seed: int = 0,
    *,
    track_energy: bool = True,
    device=None,
) -> PTResult:
    """Parallel tempering on ``device`` (``cuda`` unless the caller passes
    ``device='cpu'``).  ``energy_min`` holds the chain-best energy after
    each round when ``track_energy``."""
    maxcut, model = normalize_problem(problem)
    dev = resolve_device(device)
    h, nbr_idx, nbr_w = model.device_arrays(dev)
    nbr_idx = nbr_idx.to(torch.int64)
    n, R = model.n, hp.n_replicas
    # Geometric ladder (hot → cold), in float64 on the host, then float32.
    temps = torch.as_tensor(
        np.asarray(hp.t_max * (hp.t_min / hp.t_max) ** (np.arange(R) / max(R - 1, 1)),
                   np.float32), device=dev)
    inv_t = 1.0 / temps
    a = torch.arange(R - 1, device=dev)
    dB = inv_t[a] - inv_t[a + 1]
    ar = torch.arange(R, device=dev)

    key = PRNGKey(seed)
    key, k0 = split(key)
    m = torch.where(bernoulli(k0, 0.5, (R, n), device=dev), 1, -1).to(torch.int32)
    H = _sa_energy(h[None], nbr_idx[None], nbr_w[None], m[None])[0]
    b0 = torch.argmin(H)
    best_H, best_m = H[b0], m[b0]
    rounds = hp.n_cycles // hp.swap_interval
    round_keys = np.asarray(split(key, rounds), np.int64).reshape(-1, 2)
    mins = []
    for r0 in range(0, rounds, _ROUND_BLOCK):
        r1 = min(rounds, r0 + _ROUND_BLOCK)
        sites, log_acc, log_swap = _pt_draws(round_keys[r0:r1], R, n, hp.swap_interval, dev)
        for r in range(r1 - r0):
            m = m.clone()
            for c in range(hp.swap_interval):
                i = sites[r, c]
                mi = m[ar, i]
                neigh = torch.gather(m, 1, nbr_idx[i])
                local = h[i] + (nbr_w[i] * neigh).sum(dim=-1, dtype=torch.int32)
                dH = 2 * mi * local
                accept = (dH <= 0) | (log_acc[r, c] < -dH.to(torch.float32) * inv_t)
                m[ar, i] = torch.where(accept, -mi, mi)
                H = H + torch.where(accept, dH, 0)
            # Swap adjacent rungs of this round's parity.
            pair = (a % 2) == ((r0 + r) % 2)
            dE = (H[a] - H[a + 1]).to(torch.float32)
            perm = _swap_perm(pair & (log_swap[r] < dB * dE), R)
            m, H = m[perm], H[perm]
            rb = torch.argmin(H)
            better = H[rb] < best_H
            best_H = torch.where(better, H[rb], best_H)
            best_m = torch.where(better, m[rb], best_m)
            if track_energy:
                mins.append(best_H)
    best_H = int(best_H)
    return PTResult(
        best_cut=int(finalize_cut(best_H, maxcut)),
        best_energy=best_H,
        best_m=best_m.cpu().numpy(),
        energy_mean=None,
        energy_min=torch.stack(mins).cpu().numpy() if track_energy else None,
        hp=hp,
    )


# ---------------------------------------------------------------------------
# PT-SSA: the replica ladder on the plateau engine's trial axis
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PTSSAHyperParams:
    """PT in the engine's terms: replicas = trials, rungs = I0.

    ``n_rounds`` plateau+swap rounds of ``tau`` cycles each; the I0 ladder
    is geometric from i0_min (hot) to i0_max (cold) across ``n_replicas``.
    ``beta_scale`` maps a rung's I0 to the inverse temperature of the swap
    test.
    """

    n_replicas: int = 8
    n_rounds: int = 60
    tau: int = 100
    i0_min: int = 1
    i0_max: int = 32
    n_rnd: int = 2
    beta_scale: float = 0.25

    def ladder(self) -> np.ndarray:
        """(R,) int32 I0 per replica, geometric hot → cold."""
        R = self.n_replicas
        ratio = (self.i0_max / self.i0_min) ** (1.0 / max(R - 1, 1))
        lad = np.round(self.i0_min * ratio ** np.arange(R))
        return np.clip(lad, self.i0_min, self.i0_max).astype(np.int32)

    @property
    def total_cycles(self) -> int:
        return self.n_rounds * self.tau


@dataclasses.dataclass
class PTSSAResult(BaseResult):
    """Per-replica best (arrays over the replica axis)."""

    hp: PTSSAHyperParams


def pt_ssa_swap_keys(seed: int, n_rounds: int) -> np.ndarray:
    """The (n_rounds, 2) swap keys of a PT-SSA run: ``split(PRNGKey(seed ^
    0x5CA1AB1E), n_rounds)``, as the JAX package derives them."""
    return np.asarray(split(PRNGKey(seed ^ 0x5CA1AB1E), n_rounds), np.int64).reshape(-1, 2)


def pt_ssa_rounds(field_fn, noise_step, h, hp: PTSSAHyperParams, state: EngineState,
                  keys, parities) -> EngineState:
    """Advance k plateau+swap rounds.

    Each round: one plateau of ``tau`` cycles at the per-replica I0 column
    (always storage-eligible: PT tracks its best continuously), then one
    swap of adjacent rungs at the round's parity, which permutes (m,
    Itanh); the running best stays with the rung that saw it.

    One problem: spins (R, N), ``keys`` (k, 2).  B stacked problems (the
    service): spins (B, R, N), ``h`` (B, 1, N) and ``keys`` (B, k, 2), each
    problem swapping under its own keys.  ``parities`` is (k,).
    """
    keys = np.asarray(keys, np.int64)
    dev = state.m.device
    ladder = torch.as_tensor(hp.ladder(), device=dev)
    i0_col = ladder[:, None]
    betas = torch.tensor(hp.beta_scale, dtype=torch.float32) * ladder.to(torch.float32)
    R = hp.n_replicas
    a = torch.arange(R - 1, device=dev)
    dB = betas[a] - betas[a + 1]
    log_u = xla_log(uniform(torch.as_tensor(keys, device=dev), (R - 1,), minval=1e-12,
                            device=dev))                     # (..., k, R-1)
    parities = [int(p) for p in np.asarray(parities)]
    st = state
    for r, parity in enumerate(parities):
        st, _, _ = run_plateau_scan(field_fn, noise_step, h, hp.n_rnd, st, i0_col,
                                    length=hp.tau, eligible=True)
        H = energy_from_field(st.m, field_fn(st.m), h)
        dE = (H[..., :-1] - H[..., 1:]).to(torch.float32)
        do_swap = ((a % 2) == parity) & (log_u[..., r, :] < dB * dE)
        perm = _swap_perm(do_swap, R)
        st = EngineState(st.noise_state, _permute(st.m, perm), _permute(st.itanh, perm),
                         st.best_H, st.best_m)
    return st


def anneal_pt_ssa(
    problem: Union[MaxCutProblem, IsingModel],
    hp: PTSSAHyperParams = PTSSAHyperParams(),
    seed: int = 0,
    *,
    backend: str = "sparse",
    noise: str = "xorshift",
    device=None,
) -> PTSSAResult:
    """PT on the plateau engine (replicas = trials, per-replica I0 clamp) on
    ``device`` (``cuda`` unless the caller passes ``device='cpu'``).

    ``backend`` must be 'sparse', 'dense' or 'auto', which takes 'dense':
    the CUDA plateau kernels take a scalar plateau I0, so PT-SSA runs the
    scan path.
    """
    if backend == "auto":
        backend = "dense"
    if backend == "cuda":
        raise ValueError(
            "pt-ssa needs a per-replica I0 column; the resident cuda "
            "kernels are scalar-I0 — use backend='sparse' or 'dense'"
        )
    maxcut, model = normalize_problem(problem)
    bk = make_backend(backend, model, n_trials=hp.n_replicas, n_rnd=hp.n_rnd, noise=noise,
                      device=device)
    state = bk.init_state(seed)
    parities = np.arange(hp.n_rounds, dtype=np.int32) % 2
    state = pt_ssa_rounds(bk._field, bk._noise_step, bk.h, hp, state,
                          pt_ssa_swap_keys(seed, hp.n_rounds), parities)
    best_H, best_m = bk.finalize(state)
    best_H = best_H.cpu().numpy()
    return PTSSAResult(
        best_cut=np.asarray(finalize_cut(best_H, maxcut)),
        best_energy=best_H,
        best_m=best_m.cpu().numpy(),
        energy_mean=None,
        energy_min=None,
        hp=hp,
    )
