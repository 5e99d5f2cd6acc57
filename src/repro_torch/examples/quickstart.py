"""Quickstart: solve a MAX-CUT instance with HA-SSA (the paper in 25 lines).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--backend auto]
"""
import argparse

from repro_torch.core import gset, memory
from repro_torch.core.config import SolverConfig
from repro_torch.core.ssa import SSAHyperParams, anneal


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="auto", choices=("sparse", "dense", "cuda", "auto"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    # G11-class instance: 800-vertex toroidal 4-regular graph, ±1 weights
    problem = gset.load("G11")

    # Table-II hyperparameters, scaled down for a quick demo
    hp = SSAHyperParams(n_trials=16, m_shot=20, n_rnd=2, i0_min=1, i0_max=32,
                        tau=100, beta_shift=1)

    # storage='i0max' is HA-SSA: spin states kept only while I0 == I0max;
    # threefry noise is anneal()'s default, as in the JAX package
    result = anneal(problem, hp, seed=0, storage="i0max", device=args.device,
                    config=SolverConfig(backend=args.backend, noise="threefry"))

    print(f"problem: {problem.name} (N={problem.n}, |E|={len(problem.edges)})")
    print(f"cycles per trial: {hp.total_cycles}")
    print(f"best cut  : {result.overall_best_cut}")
    print(f"mean cut  : {result.mean_best_cut:.1f} over {hp.n_trials} trials")
    print(f"best energy: {result.best_energy.min()}")
    print(f"trajectory memory: HA-SSA {memory.hassa_bits_per_iteration(problem.n, hp)} "
          f"bits/iter vs SSA {memory.ssa_bits_per_iteration(problem.n, hp)} "
          f"({memory.memory_ratio(hp)}x saving)")


if __name__ == "__main__":
    main()
