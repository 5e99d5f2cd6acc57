"""The paper's Fig. 7 / Fig. 9: mean Ising energy against cycles, HA-SSA
against SSA and SA (the port of the JAX repo's ``benchmarks/convergence.py``).

    python -m repro_torch.benchmarks.convergence [--trials 100 --m-shot 150] [--device cpu]

Derived rows reproduce the paper's headline claims: the cycles HA-SSA takes
to reach 96% of its best mean energy against the cycles SA takes to reach
the same energy (the "58–114× faster" convergence claim; SA that never
reaches it is charged the whole run), and HA-SSA's cut beside SSA's (one
update path, two storage policies).  HA-SSA and SSA run with xorshift noise
on ``backend`` (the traces take the cycle loop: K3 on 'cuda'), SA on the
same device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import gset
from repro_torch.core.config import SolverConfig
from repro_torch.core.sa import SAHyperParams, anneal_sa
from repro_torch.core.ssa import SSAHyperParams, anneal

from .common import emit


def cycles_to(energy_mean: np.ndarray, target: float, cycles: int) -> int:
    """The first cycle (1-based) whose mean energy is at or below ``target``;
    ``cycles`` when none is."""
    hit = energy_mean <= target
    return int(np.argmax(hit) + 1) if hit.any() else cycles


def run(problems=("G11", "G12", "G13"), trials: int = 8, m_shot: int = 20,
        backend: str = "sparse", csv_prefix: str = "fig7_convergence", device=None):
    """Reduced scale by default (the paper's: trials=100, m_shot=150)."""
    cfg = SolverConfig(backend=backend, noise="xorshift")
    rows = {}
    for name in problems:
        p = gset.load(name)
        hp = SSAHyperParams(n_trials=trials, m_shot=m_shot)
        cycles = hp.total_cycles

        t0 = time.perf_counter()
        r_ha = anneal(p, hp, seed=0, storage="i0max", config=cfg, device=device)
        t_ha = (time.perf_counter() - t0) * 1e6

        t0 = time.perf_counter()
        r_ssa = anneal(p, hp, seed=0, storage="all", schedule_kind="ssa", config=cfg,
                       device=device)
        t_ssa = (time.perf_counter() - t0) * 1e6

        t0 = time.perf_counter()
        r_sa = anneal_sa(p, SAHyperParams(n_trials=trials, n_cycles=cycles), seed=0,
                         device=device)
        t_sa = (time.perf_counter() - t0) * 1e6

        # The target: 96% of HA-SSA's best mean energy (the paper's yardstick).
        target = 0.96 * r_ha.energy_mean.min()
        c_ha = cycles_to(r_ha.energy_mean, target, cycles)
        c_sa = cycles_to(r_sa.energy_mean, target, cycles)
        speedup = c_sa / max(c_ha, 1)

        emit(f"{csv_prefix}/{name}/hassa", t_ha,
             f"best_cut={r_ha.overall_best_cut};mean_cut={r_ha.mean_best_cut:.1f};"
             f"cycles_to_96pct={c_ha}")
        emit(f"{csv_prefix}/{name}/ssa", t_ssa,
             f"best_cut={r_ssa.overall_best_cut};mean_cut={r_ssa.mean_best_cut:.1f}")
        emit(f"{csv_prefix}/{name}/sa", t_sa,
             f"best_cut={r_sa.overall_best_cut};mean_cut={r_sa.mean_best_cut:.1f};"
             f"cycles_to_96pct={c_sa}")
        emit(f"{csv_prefix}/{name}/speedup_vs_sa", 0.0, f"convergence_speedup={speedup:.1f}x")
        rows[name] = dict(speedup=speedup, ha=r_ha, sa=r_sa, ssa=r_ssa, c_ha=c_ha, c_sa=c_sa,
                          t_ha=t_ha, t_ssa=t_ssa, t_sa=t_sa)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problems", default="G11,G12,G13")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--m-shot", type=int, default=20)
    ap.add_argument("--backend", default="sparse",
                    choices=("sparse", "dense", "cuda", "auto"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    run(args.problems.split(","), args.trials, args.m_shot, args.backend, device=args.device)


if __name__ == "__main__":
    main()
