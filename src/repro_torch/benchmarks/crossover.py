"""Where ``backend='auto'`` switches: the dense backend against the resident
CUDA kernels, by spin count, on the card (``engine.MIN_RESIDENT_N``).

    python -m repro_torch.benchmarks.crossover [--sizes 16,32,...] [--repeats 3]

At Table II widths (100 trials, τ = 100, I0 1→32, n_rnd 2, xorshift noise,
``field_mode='dense'``) with ``m_shot`` cut to 1 (600 cycles), on the
``gset.toroidal_grid(n)`` twins, it times two paths on ``backend='dense'``
and ``backend='cuda'``: ``anneal()`` (production: no traces, K1 on
'cuda'), and ``AnnealService.solve`` of B = 4 requests (seeds 0–3) in one
bucket (the service's default ``min_bucket``, so small n share bucket 64).
Each time is the wall time of the whole call, set-up included, after one
warm-up call (the service keeps its program cache between calls): the
median of ``repeats`` calls.  The two backends must give the same best
energies (they are bit-identical); a difference raises.

The threshold it derives is the smallest n of the sweep from which 'cuda'
is no slower than 'dense' on both paths at every larger size of the sweep
(None if no such n).  Prints ``name,us_per_call,derived`` rows and returns
the table.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import gset
from repro_torch.core.config import SolverConfig
from repro_torch.core.engine import MIN_RESIDENT_N, bucket_n
from repro_torch.core.ssa import SSAHyperParams, anneal
from repro_torch.serve import AnnealRequest, AnnealService

from .common import emit

SIZES = (16, 32, 64, 128, 256, 512, 1024, 2048)
BACKENDS = ("dense", "cuda")
SERVICE_B = 4


def _timed(fn, device, repeats: int):
    """(median wall s of ``repeats`` calls after one warm-up, last result)."""
    out = fn()
    times = []
    for _ in range(int(repeats)):
        t0 = time.perf_counter()
        out = fn()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def threshold(rows) -> int | None:
    """The smallest n of ``rows`` from which 'cuda' is no slower than
    'dense' on both paths at every larger n (None if none is)."""
    best = None
    for row in sorted(rows, key=lambda r: -r["n"]):
        if row["anneal_cuda_s"] <= row["anneal_dense_s"] and \
                row["service_cuda_s"] <= row["service_dense_s"]:
            best = row["n"]
        else:
            break
    return best


def run(sizes=SIZES, repeats: int = 3, device=None, csv_prefix: str = "crossover"):
    device = "cuda" if device is None else device
    hp = SSAHyperParams(n_trials=100, m_shot=1)
    rows = []
    for n in sizes:
        p = gset.toroidal_grid(int(n))
        row = {"n": int(n), "bucket": bucket_n(int(n))}
        for bk in BACKENDS:
            cfg = SolverConfig(backend=bk, noise="xorshift", field_mode="dense")
            t_a, r_a = _timed(lambda: anneal(p, hp, seed=0, track_energy=False, config=cfg,
                                             device=device), device, repeats)
            svc = AnnealService(backend=bk, noise="xorshift",
                                backend_opts={"field_mode": "dense"}, device=device)
            reqs = [AnnealRequest(problem=p, hp=hp, seed=s) for s in range(SERVICE_B)]
            t_s, r_s = _timed(lambda: svc.solve(reqs), device, repeats)
            row[f"anneal_{bk}_s"], row[f"service_{bk}_s"] = t_a, t_s
            row[f"_energies_{bk}"] = (r_a.best_energy,
                                      [r.result.best_energy for r in r_s])
        (ea_d, es_d), (ea_c, es_c) = row.pop("_energies_dense"), row.pop("_energies_cuda")
        if not (np.array_equal(ea_d, ea_c)
                and all(np.array_equal(a, b) for a, b in zip(es_d, es_c))):
            raise AssertionError(f"n={n}: the dense and cuda backends disagree")
        for path in ("anneal", "service"):
            emit(f"{csv_prefix}/n{n}/{path}", row[f"{path}_cuda_s"] * 1e6,
                 f"dense_s={row[f'{path}_dense_s']:.6f};cuda_s={row[f'{path}_cuda_s']:.6f};"
                 f"bucket={row['bucket']}")
        rows.append(row)
    derived = threshold(rows)
    emit(f"{csv_prefix}/threshold", 0.0,
         f"derived={derived};MIN_RESIDENT_N={MIN_RESIDENT_N}")
    return {"rows": rows, "threshold": derived, "min_resident_n": MIN_RESIDENT_N}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' times the CPU, not the card)")
    args = ap.parse_args(argv)
    run([int(s) for s in args.sizes.split(",")], args.repeats, args.device)


if __name__ == "__main__":
    main()
