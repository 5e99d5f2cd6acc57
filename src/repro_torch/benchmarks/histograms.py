"""The paper's Fig. 8 / Fig. 10: histograms of the cut values over trials
(the port of the JAX repo's ``benchmarks/histograms.py``).

    python -m repro_torch.benchmarks.histograms [--trials 100 --m-shot 150] [--device cpu]

The claim reproduced: HA-SSA's best and mean cut equal conventional SSA's
(one update path, two storage policies), and both beat SA's at the same
cycle count.  HA-SSA and SSA run with xorshift noise on ``backend`` (no
traces: K1 on 'cuda'), SA on the same device.
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


def run(problems=("G11", "G12", "G13"), trials: int = 16, m_shot: int = 15,
        csv_prefix: str = "fig8_histogram", backend: str = "sparse", device=None):
    cfg = SolverConfig(backend=backend, noise="xorshift")
    out = {}
    for name in problems:
        p = gset.load(name)
        hp = SSAHyperParams(n_trials=trials, m_shot=m_shot)
        t0 = time.perf_counter()
        r_ha = anneal(p, hp, seed=1, storage="i0max", track_energy=False, config=cfg,
                      device=device)
        t_ha = (time.perf_counter() - t0) * 1e6
        r_ssa = anneal(p, hp, seed=1, storage="all", track_energy=False, config=cfg,
                       device=device)
        r_sa = anneal_sa(p, SAHyperParams(n_trials=trials, n_cycles=hp.total_cycles),
                         seed=1, track_energy=False, device=device)
        hist_ha, _ = np.histogram(r_ha.best_cut, bins=8)
        emit(f"{csv_prefix}/{name}/hassa", t_ha,
             f"best={r_ha.overall_best_cut};avg={r_ha.mean_best_cut:.1f};"
             f"hist={'|'.join(map(str, hist_ha))}")
        emit(f"{csv_prefix}/{name}/ssa", 0.0,
             f"best={r_ssa.overall_best_cut};avg={r_ssa.mean_best_cut:.1f}")
        emit(f"{csv_prefix}/{name}/sa", 0.0,
             f"best={r_sa.overall_best_cut};avg={r_sa.mean_best_cut:.1f}")
        eq = (r_ha.overall_best_cut == r_ssa.overall_best_cut
              and abs(r_ha.mean_best_cut - r_ssa.mean_best_cut) < 1e-9)
        emit(f"{csv_prefix}/{name}/hassa_equals_ssa", 0.0, str(eq))
        out[name] = (r_ha, r_ssa, r_sa)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problems", default="G11,G12,G13")
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--m-shot", type=int, default=15)
    ap.add_argument("--backend", default="sparse",
                    choices=("sparse", "dense", "cuda", "auto"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    run(args.problems.split(","), args.trials, args.m_shot, backend=args.backend,
        device=args.device)


if __name__ == "__main__":
    main()
