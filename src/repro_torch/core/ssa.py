"""SSA and HA-SSA annealers (port of ``repro.core.ssa``).

Every spin is a p-bit updated simultaneously each cycle:

    I_i(t+1)     = h_i + Σ_j J_ij m_j(t) + n_rnd · r_i(t) + Itanh_i(t)   (2a)
    Itanh_i(t+1) = clamp(I_i(t+1), -I0(t), I0(t)-1)                       (2b)
    m_i(t+1)     = +1 if Itanh_i(t+1) >= 0 else -1                        (2c)

SSA and HA-SSA differ only in temperature control (Eq. 3 vs Eq. 4), the
storage policy (every plateau vs only I0 == I0max) and duration control
(HA-SSA counts whole iterations).  :func:`anneal` drives the plateau engine
of :mod:`repro_torch.core.engine`: ``m_shot`` iterations of ``steps``
plateaus, each advanced by the configured backend — with
``SolverConfig(backend='cuda')`` one launch of the CUDA plateau kernel per
plateau when no per-cycle output is asked for (K1 with streamed xorshift
noise, K4 with pregenerated noise).  SSQA hyper-parameters
(:class:`repro_torch.core.ssqa.SSQAHyperParams`) run the same plateau loop with
the Trotter-replica coupling.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .config import SolverConfig
from .engine import (
    BaseResult,
    energy_from_field,
    finalize_cut,
    make_backend,
    normalize_problem,
    run_schedule,
    schedule_plateaus,
    tile_plateaus,
    unpack_spins,
)
from .ising import IsingModel, MaxCutProblem
from .schedule import Schedule, hassa_schedule, n_temp_steps, ssa_schedule

__all__ = ["SSAHyperParams", "AnnealResult", "anneal", "solve_maxcut"]


@dataclasses.dataclass(frozen=True)
class SSAHyperParams:
    """Table II defaults: trial=100, m_shot=150, n_rnd=2, I0: 1→32, τ=100, β=1."""

    n_trials: int = 100
    m_shot: int = 150
    n_rnd: int = 2
    i0_min: int = 1
    i0_max: int = 32
    tau: int = 100
    beta_shift: int = 1  # HA-SSA Eq.(4) β; equivalent SSA Eq.(3) β = 2^-beta_shift

    @property
    def steps(self) -> int:
        return n_temp_steps(self.i0_min, self.i0_max, self.beta_shift)

    @property
    def cycles_per_iter(self) -> int:
        return self.steps * self.tau

    @property
    def total_cycles(self) -> int:
        return self.m_shot * self.cycles_per_iter

    def schedule(self, kind: str = "hassa") -> Schedule:
        if kind == "hassa":
            return hassa_schedule(self.i0_min, self.i0_max, self.tau, self.beta_shift)
        if kind == "ssa":
            return ssa_schedule(self.i0_min, self.i0_max, self.tau, 2.0 ** (-self.beta_shift))
        raise ValueError(kind)


@dataclasses.dataclass
class AnnealResult(BaseResult):
    """Outcome of one annealing run over a batch of trials (numpy)."""

    traj: Optional[np.ndarray]    # (m_shot, stored_cycles, T, Nw) uint32 words
    stored_bits_per_iter: int     # N × stored_cycles — the Eq.(5)/(6) witness
    hp: SSAHyperParams


def _best_of_planes(bk, planes, maxcut, best):
    """Fold one iteration's stored planes (S, T, Nw) into the running
    (score, H, m) best, keeping the first best state in storage order."""
    S, T, _ = planes.shape
    n = bk.model.n
    spins = unpack_spins(planes, n).reshape(S * T, n)
    H = energy_from_field(spins, bk._field(spins), bk.h).reshape(S, T)
    score = (maxcut.w_total - H) // 2 if maxcut is not None else -H
    idx = torch.argmax(score, dim=0)             # first maximum per trial
    tt = torch.arange(T, device=H.device)
    cand = (score[idx, tt], H[idx, tt], spins.reshape(S, T, n)[idx, tt])
    if best is None:
        return cand
    better = cand[0] > best[0]
    return (
        torch.where(better, cand[0], best[0]),
        torch.where(better, cand[1], best[1]),
        torch.where(better[:, None], cand[2], best[2]),
    )


def anneal(
    problem: Union[MaxCutProblem, IsingModel],
    hp: Union[SSAHyperParams, str] = SSAHyperParams(),
    seed: int = 0,
    *,
    storage: str = "i0max",        # 'i0max' (HA-SSA) | 'all' (conventional SSA)
    record: str = "best",          # 'best' | 'traj'
    track_energy: bool = True,
    schedule_kind: str = "hassa",  # 'hassa' Eq.(4) | 'ssa' Eq.(3)
    total_cycles: Optional[int] = None,  # cycle-count duration (Fig. 12 mode)
    auto_base: Optional[SSAHyperParams] = None,  # budget knobs for hp='auto'
    config: Optional[SolverConfig] = None,
    device=None,
) -> AnnealResult:
    """Run SSA/HA-SSA on a MAX-CUT or Ising problem.

    ``storage='i0max'`` + ``schedule_kind='hassa'`` is the paper's HA-SSA;
    ``storage='all'`` + ``schedule_kind='ssa'`` is conventional SSA.
    ``config`` holds the execution options; ``SolverConfig(partition=
    'spin', mesh=spin_mesh(...))`` shards the spin axis over the mesh's
    ranks, every rank calling ``anneal()`` and getting the same result.
    Without one, ``anneal()``
    runs ``SolverConfig(noise='threefry')`` (sparse backend, threefry
    noise, dense layout), as the JAX package's ``anneal()`` does: its
    historical default noise is threefry, not ``SolverConfig``'s xorshift.  ``device`` defaults to
    ``cuda``; pass ``device='cpu'`` to run on the CPU.

    ``record='best'`` tracks the running arg-best over storage-eligible
    plateaus (``track_energy`` adds per-cycle mean/min energy traces);
    ``record='traj'`` returns the stored packed planes and picks the best
    among them.  ``total_cycles`` truncates the run to a cycle count
    (record='best' only).

    ``hp='auto'`` derives n_rnd, the I0 clamp and the per-plateau τ from
    the instance's local-field distribution
    (:mod:`repro_torch.core.autotune`), with the budget knobs of
    ``auto_base`` (default: Table II).  An hp with ``n_replicas`` (SSQA)
    builds the backend with that Trotter-replica count, and its schedule
    carries the J⊥ ramp.
    """
    maxcut, model = normalize_problem(problem)
    if isinstance(hp, str):
        from .autotune import resolve_hyperparams  # autotune imports this module

        hp, _ = resolve_hyperparams(hp, model, base=auto_base)
    cfg = SolverConfig(noise="threefry") if config is None else config
    sched = hp.schedule(schedule_kind)
    opts = cfg.engine_opts()
    # SSQA hyper-parameters carry the replica count; read by attribute, as
    # core.ssqa imports this module.
    nr = int(getattr(hp, "n_replicas", 0) or 0)
    if nr:
        opts.setdefault("n_replicas", nr)
    bk = make_backend(
        cfg.backend, model, n_trials=hp.n_trials, n_rnd=hp.n_rnd,
        noise=cfg.noise, partition=cfg.partition, mesh=cfg.mesh, device=device, **opts,
    )
    plateaus = schedule_plateaus(sched, storage)
    stored_per_iter = sum(p.length for p in plateaus if p.eligible)
    e_mean = e_min = traj = None

    state = bk.init_state(seed)
    if record == "traj":
        planes_per_iter, best = [], None
        for _ in range(hp.m_shot):
            state, _, planes = run_schedule(bk, plateaus, state, record="traj")
            planes_per_iter.append(planes)
            best = _best_of_planes(bk, planes, maxcut, best)
        _, best_H, best_m = best
        traj = torch.stack(planes_per_iter)
    elif record == "best":
        if total_cycles is None:
            chains = [plateaus] * hp.m_shot
        else:
            full_iters, rem = divmod(int(total_cycles), sched.cycles_per_iter)
            chains = [plateaus] * full_iters
            if rem:
                chains.append(tile_plateaus(plateaus, rem))
        traces = []
        for chain in chains:
            state, trace, _ = run_schedule(
                bk, chain, state, record="best", track_energy=track_energy
            )
            if track_energy:
                traces.append(trace)
        best_H, best_m = bk.finalize(state)
        if track_energy:
            e_mean = torch.cat([t[0] for t in traces]).cpu().numpy()
            e_min = torch.cat([t[1] for t in traces]).cpu().numpy()
    else:
        raise ValueError(f"unknown record {record!r}")

    best_H = best_H.cpu().numpy()
    return AnnealResult(
        best_cut=np.asarray(finalize_cut(best_H, maxcut)),
        best_energy=best_H,
        best_m=best_m.cpu().numpy(),
        energy_mean=e_mean,
        energy_min=e_min,
        traj=None if traj is None else traj.cpu().numpy().view(np.uint32),
        stored_bits_per_iter=model.n * stored_per_iter,
        hp=hp,
    )


def solve_maxcut(problem: MaxCutProblem, hp: SSAHyperParams = SSAHyperParams(), **kw) -> AnnealResult:
    """Convenience wrapper with HA-SSA defaults (the paper's configuration)."""
    return anneal(problem, hp, **kw)
