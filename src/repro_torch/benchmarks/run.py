"""Benchmark harness entry point of the port (the JAX repo's
``benchmarks/run.py``): ``python -m repro_torch.benchmarks.run [--full]``.

One module per paper table or figure:
  memory_table   — Table IV    Eq. (5)/(6) memory model, measured beside it
  convergence    — Fig. 7/9    energy against cycles, HA-SSA/SSA/SA
  histograms     — Fig. 8/10   cut-value distributions over trials
  pt_compare     — Table VII   against parallel tempering
  equal_temp     — Fig. 12     equivalent temperature control
  other_problems — Sec. VI-B   the problem families through the service

``timing`` (Table V), ``kernel_bench`` and ``roofline`` are not ported: a
run prints that on stderr, and ``--only`` naming one raises
NotImplementedError naming its ROADMAP.md item.  ``--backend`` (default
'auto': the CUDA kernels from ``engine.MIN_RESIDENT_N`` spins) is the
backend of the HA-SSA runs; ``--device cpu`` runs on the CPU.

Output: ``name,us_per_call,derived`` CSV rows.  Exits 1 if memory_table's
gate or other_problems' checks fail.
"""
from __future__ import annotations

import argparse
import sys

NOT_PORTED = {
    "timing": "ROADMAP.md queue 1 step 9 (timing.py, Table V: the port's first "
              "benchmark PR)",
    "kernel_bench": "ROADMAP.md queue 1 step 9 (kernel_bench.py: the port's first "
                    "benchmark PR)",
    "roofline": "ROADMAP.md queue 1 step 9 (roofline.py: reads launch.dryrun artifacts, "
                "step 10)",
}


def jobs(full: bool, backend: str, device):
    from . import (convergence, equal_temp, histograms, memory_table, other_problems,
                   pt_compare)

    return {
        "memory_table": lambda: memory_table.run(backend=backend, device=device),
        "convergence": lambda: convergence.run(
            trials=100 if full else 8, m_shot=150 if full else 20, backend=backend,
            device=device),
        "histograms": lambda: histograms.run(
            trials=100 if full else 16, m_shot=150 if full else 15, backend=backend,
            device=device),
        "pt_compare": lambda: pt_compare.run(
            trials=100 if full else 8, m_shot=150 if full else 15, device=device),
        "equal_temp": lambda: equal_temp.run(trials=100 if full else 8, backend=backend,
                                             device=device),
        "other_problems": lambda: other_problems.run(device=device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="paper-scale trials and cycles (slow: 100 trials × 90k cycles)")
    ap.add_argument("--only", default=None, help="comma-separated subset of benchmark names")
    ap.add_argument("--backend", default="auto", choices=("sparse", "dense", "cuda", "auto"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    table = jobs(args.full, args.backend, args.device)
    only = args.only.split(",") if args.only else None
    for name in only or ():
        if name in NOT_PORTED:
            raise NotImplementedError(f"benchmark {name!r} is not ported to repro_torch; it "
                                      f"waits for {NOT_PORTED[name]}")
        if name not in table:
            raise ValueError(f"unknown benchmark {name!r}; known: "
                             f"{sorted(table) + sorted(NOT_PORTED)}")
    if only is None:
        for name, item in NOT_PORTED.items():
            print(f"not run: {name} is not ported; it waits for {item}", file=sys.stderr)
    print("name,us_per_call,derived")
    failed = []
    for name, job in table.items():
        if only and name not in only:
            continue
        out = job()
        if (name == "memory_table" and not out["measured_ok"]) or \
                (name == "other_problems" and not out["ok"]):
            failed.append(name)
    if failed:
        print(f"FAIL: {', '.join(failed)}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
