"""The paper's Table VII: HA-SSA against parallel tempering at matched cycle
budgets (the port's ``benchmarks/pt_compare.py::run``; its SSQA
time-to-target half is reproduced by ``chip_smoke.py``).

    python -m repro_torch.benchmarks.pt_compare [--problem G11] [--device cpu]

Prints ``name,us_per_call,derived`` rows: HA-SSA's best and mean cut and
wall time, PT's best cut and wall time, and their cut difference.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import gset
from repro_torch.core.config import SolverConfig
from repro_torch.core.pt import PTHyperParams, anneal_pt
from repro_torch.core.ssa import SSAHyperParams, anneal

from .common import emit


def _sync(device):
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.synchronize()


def run(problem: str = "G11", trials: int = 8, m_shot: int = 15,
        csv_prefix: str = "table7_pt", device=None):
    """HA-SSA (``SolverConfig()``: the sparse backend with xorshift noise,
    as in the JAX package) and 8-replica PT at the same cycle budget;
    returns both results and wall times."""
    p = gset.load(problem)
    hp = SSAHyperParams(n_trials=trials, m_shot=m_shot)
    t0 = time.perf_counter()
    r_ha = anneal(p, hp, seed=0, track_energy=False, config=SolverConfig(), device=device)
    _sync(device)
    t_ha = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_pt = anneal_pt(p, PTHyperParams(n_replicas=8, n_cycles=hp.total_cycles), seed=0,
                     track_energy=False, device=device)
    _sync(device)
    t_pt = time.perf_counter() - t0
    emit(f"{csv_prefix}/{problem}/hassa", t_ha * 1e6,
         f"best={r_ha.overall_best_cut};avg={r_ha.mean_best_cut:.1f}")
    emit(f"{csv_prefix}/{problem}/pt", t_pt * 1e6, f"best={r_pt.best_cut}")
    emit(f"{csv_prefix}/{problem}/hassa_vs_pt_cut", 0.0,
         f"{r_ha.overall_best_cut - r_pt.best_cut:+d}")
    return dict(ha=r_ha, pt=r_pt, t_ha=t_ha, t_pt=t_pt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problem", default="G11")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--m-shot", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    run(args.problem, args.trials, args.m_shot, device=args.device)


if __name__ == "__main__":
    main()
