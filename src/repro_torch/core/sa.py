"""Conventional simulated annealing baseline (port of ``repro.core.sa``).

Single-spin-flip Metropolis: each cycle every trial proposes one random
spin; the flip is accepted if it lowers the Ising energy, else with
probability exp(-ΔH / T).  The temperature decays geometrically from 10 to
1e-7 over the run (the paper's CPU baseline, Sec. IV-A).

ΔH for flipping spin i is 2·m_i·(h_i + Σ_j J_ij m_j): one padded-adjacency
gather per trial and cycle.  SA runs no CUDA kernel: the JAX package's SA
is a ``lax.scan`` of gathers, not a Pallas kernel, and here each cycle is a
handful of torch operations on the backend's device.

Randomness is ``jax.random`` as the JAX package draws it, so results are
bit-identical: each cycle splits the carried key three ways (``key,
k_site, k_acc``), draws the proposed sites with ``randint(k_site)`` and
the acceptance uniforms with ``uniform(k_acc, minval=1e-12)``, and
accepts on ``log(u) · T < -ΔH`` with XLA's float32 logarithm
(:func:`repro_torch.core.xla_math.xla_log`).  The key chain runs on the
host (one threefry hash per cycle); the draws of a block of cycles are
made at once on the device, then the cycles run one by one.

The cores work on a leading problem axis (B stacked, bucket-padded
problems, as the service runs them); the single-problem functions are
their B = 1 case.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .engine import BaseResult, finalize_cut, normalize_problem, resolve_device
from .ising import IsingModel, MaxCutProblem
from .rng import PRNGKey, bernoulli, randint, split_keys, threefry2x32, uniform
from .schedule import sa_temperature_ladder
from .xla_math import xla_log

__all__ = ["SAHyperParams", "SAResult", "SACarry", "anneal_sa", "sa_init", "sa_cycles",
           "sa_run", "sa_init_batched", "sa_cycles_batched"]

# Cycles whose draws are made in one pass (bounds the int64 temporaries of
# the threefry hash: about ten live (B, block, T) tensors).
_DRAW_BLOCK = 2048


@dataclasses.dataclass(frozen=True)
class SAHyperParams:
    n_trials: int = 100
    n_cycles: int = 90_000
    t_start: float = 10.0
    t_end: float = 1e-7


@dataclasses.dataclass
class SAResult(BaseResult):
    hp: SAHyperParams


class SACarry(NamedTuple):
    """The SA carry with a leading problem axis: keys (B, 2) int64 (host),
    spins (B, T, N) int32, energies (B, T) int32 and the running best."""

    key: np.ndarray
    m: torch.Tensor
    H: torch.Tensor
    best_H: torch.Tensor
    best_m: torch.Tensor


# Elements of the (trials, N, D) neighbour gather of the start energy held
# at once: the trials go in blocks (a dense K2000 start would gather 1.6 GB).
_GATHER_ELEMS = 1 << 24


def _sa_energy(h, nbr_idx, nbr_w, m):
    """-(h·m + m·(Jm) // 2) per trial, int32; h (B, N), adjacency (B, N, D),
    m (B, T, N)."""
    B, T, N = m.shape
    idx = nbr_idx.to(torch.int64).reshape(B, 1, -1)
    per = max(1, _GATHER_ELEMS // max(1, B * idx.shape[-1]))
    out = []
    for t in range(0, T, per):
        mt = m[:, t:t + per]
        k = mt.shape[1]
        neigh = torch.gather(mt, 2, idx.expand(B, k, -1)).reshape(B, k, N, -1)
        fields = (nbr_w[:, None] * neigh).sum(dim=-1, dtype=torch.int32)
        hm = (h[:, None] * mt).sum(dim=-1, dtype=torch.int32)
        out.append(-(hm + (mt * fields).sum(dim=-1, dtype=torch.int32) // 2))
    return torch.cat(out, dim=1)


def sa_init_batched(h, nbr_idx, nbr_w, keys, *, n_trials: int) -> SACarry:
    """Random ±1 start of B problems from their (B, 2) keys: ``key, k0 =
    split(key)``; ``m0 = bernoulli(k0, 0.5, (T, N))``."""
    ks = split_keys(np.asarray(keys, np.int64).reshape(-1, 2), 2)
    n = h.shape[-1]
    plus = bernoulli(ks[:, 1], 0.5, (int(n_trials), n), device=h.device)
    m0 = torch.where(plus, 1, -1).to(torch.int32)
    H0 = _sa_energy(h, nbr_idx, nbr_w, m0)
    return SACarry(ks[:, 0], m0, H0, H0, m0)


def _key_chain(keys: np.ndarray, n_cycles: int):
    """The carried key of every cycle: (B, C, 2) keys k_c, k_{c+1} =
    ``split(k_c, 3)[0]``, and the keys after the last cycle (B, 2)."""
    B = keys.shape[0]
    chain = np.empty((B, n_cycles, 2), np.int64)
    out = np.empty((B, 2), np.int64)
    for b in range(B):
        k0, k1 = int(keys[b, 0]), int(keys[b, 1])
        for c in range(n_cycles):
            chain[b, c] = (k0, k1)
            k0, k1 = threefry2x32(k0, k1, 0, 0)
        out[b] = (k0, k1)
    return chain, out


def _draws(chain: np.ndarray, n_trials: int, n_prop, temps: torch.Tensor, device):
    """Sites (B, C, T) int64 and acceptance thresholds ``log(u)·T`` (B, C,
    T) float32 of a block of cycles from their carried keys."""
    sub = split_keys(torch.as_tensor(chain, device=device), 3)
    sites = randint(sub[:, :, 1], (n_trials,), 0, n_prop, device=device).to(torch.int64)
    u = uniform(sub[:, :, 2], (n_trials,), minval=1e-12, device=device)
    return sites, xla_log(u) * temps[None, :, None]


def sa_cycles_batched(h, nbr_idx, nbr_w, carry: SACarry, temps, *, n_live=None,
                      track_energy: bool = False):
    """Advance ``len(temps)`` Metropolis cycles of B problems.

    ``n_live`` ((B,) ints, or None for every spin) restricts the proposals
    of each problem to its live spins [0, n_live): the padded spins of a
    bucket are never proposed and stay inert.  The key rides in the carry,
    so chunked runs equal unchunked ones.  Returns (carry', trace) with
    trace = (mean_H (B, C) f32, min_H (B, C) int32) when ``track_energy``,
    else None.
    """
    device = carry.m.device
    temps = torch.as_tensor(np.asarray(temps, np.float32), device=device)
    C = int(temps.shape[0])
    B, T, N = carry.m.shape
    n_prop = (N if n_live is None
              else torch.as_tensor(np.asarray(n_live, np.int64), device=device)[:, None, None])
    chain, key = _key_chain(np.asarray(carry.key, np.int64), C)
    m, H, best_H, best_m = carry.m.clone(), carry.H, carry.best_H, carry.best_m
    ar_b = torch.arange(B, device=device)[:, None]
    ar_t = torch.arange(T, device=device)[None, :]
    nbr_idx = nbr_idx.to(torch.int64)
    means, mins = [], []
    # jnp.mean as XLA computes it: the (exact) sum times float32 1/T.
    inv_t = torch.tensor(1.0 / T, dtype=torch.float32)
    for c0 in range(0, C, _DRAW_BLOCK):
        c1 = min(C, c0 + _DRAW_BLOCK)
        sites, thr = _draws(chain[:, c0:c1], T, n_prop, temps[c0:c1], device)
        for c in range(c1 - c0):
            i = sites[:, c]                                   # (B, T)
            mi = m[ar_b, ar_t, i]
            neigh = torch.gather(m, 2, nbr_idx[ar_b, i])      # (B, T, D)
            local = h[ar_b, i] + (nbr_w[ar_b, i] * neigh).sum(dim=-1, dtype=torch.int32)
            dH = 2 * mi * local
            accept = (dH <= 0) | (thr[:, c] < -dH.to(torch.float32))
            m[ar_b, ar_t, i] = torch.where(accept, -mi, mi)
            H = H + torch.where(accept, dH, 0)
            better = H < best_H
            best_H = torch.where(better, H, best_H)
            best_m = torch.where(better[..., None], m, best_m)
            if track_energy:
                means.append(H.to(torch.float32).sum(dim=-1) * inv_t)
                mins.append(H.min(dim=-1).values)
    trace = (torch.stack(means, dim=1), torch.stack(mins, dim=1)) if track_energy else None
    return SACarry(key, m, H, best_H, best_m), trace


def _one(t):
    return t[None]


def sa_init(h, nbr_idx, nbr_w, key, *, n_trials: int):
    """Random ±1 start of one problem; returns the (key, m, H, best_H,
    best_m) carry (key a pair of ints)."""
    c = sa_init_batched(_one(h), _one(nbr_idx), _one(nbr_w),
                        np.asarray([key], np.int64), n_trials=n_trials)
    return (tuple(int(x) for x in c.key[0]), c.m[0], c.H[0], c.best_H[0], c.best_m[0])


def sa_cycles(h, nbr_idx, nbr_w, carry, temps, *, n_live=None, track_energy: bool = False):
    """Advance ``len(temps)`` Metropolis cycles of one problem (the carry of
    :func:`sa_init`).  Returns (carry', trace): trace = (mean_H (C,),
    min_H (C,)) when ``track_energy``, else None."""
    key, m, H, best_H, best_m = carry
    bc = SACarry(np.asarray([key], np.int64), _one(m), _one(H), _one(best_H), _one(best_m))
    bc, trace = sa_cycles_batched(
        _one(h), _one(nbr_idx), _one(nbr_w), bc, temps,
        n_live=None if n_live is None else [int(n_live)], track_energy=track_energy)
    out = (tuple(int(x) for x in bc.key[0]), bc.m[0], bc.H[0], bc.best_H[0], bc.best_m[0])
    return out, (None if trace is None else (trace[0][0], trace[1][0]))


def sa_run(h, nbr_idx, nbr_w, temps, key, *, n_trials: int, n_live=None,
           track_energy: bool = False):
    """Full single-problem run: :func:`sa_init` + :func:`sa_cycles`.
    Returns (best_H (T,), best_m (T, N), trace or None)."""
    carry = sa_init(h, nbr_idx, nbr_w, key, n_trials=n_trials)
    carry, trace = sa_cycles(h, nbr_idx, nbr_w, carry, temps, n_live=n_live,
                             track_energy=track_energy)
    return carry[3], carry[4], trace


def anneal_sa(
    problem: Union[MaxCutProblem, IsingModel],
    hp: SAHyperParams = SAHyperParams(),
    seed: int = 0,
    *,
    track_energy: bool = True,
    temperatures: Optional[np.ndarray] = None,  # override the ladder (Fig. 12 mode)
    device=None,
) -> SAResult:
    """SA on a MAX-CUT or Ising problem (or an encoding with a ``model``),
    on ``device`` (``cuda`` unless the caller passes ``device='cpu'``)."""
    maxcut, model = normalize_problem(problem)
    dev = resolve_device(device)
    h, nbr_idx, nbr_w = model.device_arrays(dev)
    temps = (sa_temperature_ladder(hp.t_start, hp.t_end, hp.n_cycles)
             if temperatures is None else np.asarray(temperatures, np.float32))
    best_H, best_m, trace = sa_run(h, nbr_idx, nbr_w, temps, PRNGKey(seed),
                                   n_trials=hp.n_trials, track_energy=track_energy)
    best_H = best_H.cpu().numpy()
    e_mean, e_min = trace if track_energy else (None, None)
    return SAResult(
        best_cut=np.asarray(finalize_cut(best_H, maxcut)),
        best_energy=best_H,
        best_m=best_m.cpu().numpy(),
        energy_mean=None if e_mean is None else e_mean.cpu().numpy(),
        energy_min=None if e_min is None else e_min.cpu().numpy(),
        hp=hp,
    )
