"""HA-SSA optimizes MoE expert placement: synthetic co-activation
statistics of a 64-expert layer in 8 co-firing cliques, annealed into a
balanced min-cut placement on 16 devices and compared with round-robin.

    PYTHONPATH=src python -m repro_torch.examples.expert_placement [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.placement import coactivation_stats, expert_placement

E, K, T = 64, 8, 4000


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    cliques = np.arange(E).reshape(8, 8)
    routing = np.zeros((T, K), dtype=np.int64)
    for t in range(T):
        routing[t] = rng.choice(cliques[rng.integers(0, 8)], size=K, replace=False)
        if rng.random() < 0.3:  # cross-clique noise
            routing[t, 0] = rng.integers(0, E)
    coact, load = coactivation_stats(routing, E)
    res = expert_placement(coact, load, n_devices=16, seed=0, device=args.device)
    print(f"experts={E} devices=16 tokens={T}")
    print(f"round-robin traffic cost : {res.baseline_cost:.0f}")
    print(f"HA-SSA placement cost    : {res.cost:.0f}")
    print(f"improvement              : {100 * res.improvement:.1f}%")
    print(f"assignment (expert -> device): {res.assignment.tolist()}")


if __name__ == "__main__":
    main()
