"""The paper's Fig. 12 (Sec. VI-A): SA against HA-SSA under equivalent
temperature control over a short window of cycles (the port of the JAX
repo's ``benchmarks/equal_temp.py``).

    python -m repro_torch.benchmarks.equal_temp [--trials 100] [--window 15000] [--device cpu]

SSA's pseudo-inverse temperature rises 1→32 per 600-cycle iteration; the
equivalent SA ladder falls 1 → 1/32 on the same cadence.  The paper's
point: SA does not reach the near-optimum in the window, HA-SSA converges
within ~3,000 cycles.  HA-SSA runs with xorshift noise on ``backend`` (its
trace takes the cycle loop: K3 on 'cuda'), SA on the same device.
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


def run(problem: str = "G11", trials: int = 8, window: int = 15_000,
        csv_prefix: str = "fig12_equal_temp", backend: str = "sparse", device=None):
    p = gset.load(problem)
    hp = SSAHyperParams(n_trials=trials, m_shot=-(-window // 600))
    t0 = time.perf_counter()
    r_ha = anneal(p, hp, seed=0, total_cycles=window,
                  config=SolverConfig(backend=backend, noise="xorshift"), device=device)
    t_ha = (time.perf_counter() - t0) * 1e6

    period = np.repeat(1.0 / np.array([1, 2, 4, 8, 16, 32], np.float32), hp.tau)
    temps = np.tile(period, -(-window // len(period)))[:window]
    r_sa = anneal_sa(p, SAHyperParams(n_trials=trials, n_cycles=window), seed=0,
                     temperatures=temps, device=device)
    # Cycles to come within 2% of HA-SSA's best mean energy.
    tgt = 0.98 * r_ha.energy_mean.min()
    hit = (r_ha.energy_mean <= tgt).argmax() + 1
    emit(f"{csv_prefix}/{problem}/hassa", t_ha,
         f"mean_cut={r_ha.mean_best_cut:.1f};cycles_to_98pct={int(hit)}")
    emit(f"{csv_prefix}/{problem}/sa_equal_temp", 0.0, f"mean_cut={r_sa.mean_best_cut:.1f}")
    emit(f"{csv_prefix}/{problem}/hassa_advantage", 0.0,
         f"{r_ha.mean_best_cut - r_sa.mean_best_cut:+.1f}_cut")
    return dict(ha=r_ha, sa=r_sa, cycles_to_98pct=int(hit), t_ha=t_ha)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problem", default="G11")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--window", type=int, default=15_000)
    ap.add_argument("--backend", default="sparse",
                    choices=("sparse", "dense", "cuda", "auto"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    run(args.problem, args.trials, args.window, backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()
