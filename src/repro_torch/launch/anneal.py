"""Annealing launcher of the PyTorch port (single problem).

    python -m repro_torch.launch.anneal --problem K2000 --backend cuda \
        --trials 100 --m-shot 20

Solves one G-set instance (a real file under data/gset/ if present, the
generated twin otherwise: G11, G12, G13, King1, K2000) with HA-SSA or SSA
on the plateau engine.  ``--backend cuda`` runs each plateau as one launch
of a CUDA plateau kernel: the streamed-noise kernel for ``--noise xorshift``
(the default), the pregenerated-noise kernel for ``--noise threefry`` or
``--noise-mode pregen``; with ``--field-mode popcount`` (xorshift noise
only) each iteration's plateau chain is one launch of the XNOR-popcount
chain kernel.  ``--track-energy`` and ``--record traj`` need per-cycle
outputs and run the cycle loop over the CUDA field kernel (or, under
popcount, the plain popcount field).  ``--algo ssqa`` runs SSQA: rings of
``--replicas`` Trotter replicas on the trial axis, coupled by a J⊥ ramp up
to ``--jperp-max``; on ``--backend cuda`` its coupled plateaus run the
ring modes of the streamed and popcount kernels.
Runs on the GPU unless ``--device cpu`` is given.

    python -m repro_torch.launch.anneal --problem K2000 --backend cuda \
        --algo ssqa --trials 96 --replicas 8 --jperp-max 4 --m-shot 10
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import gset, memory
from repro_torch.core.config import SolverConfig
from repro_torch.core.ssa import SSAHyperParams, anneal
from repro_torch.core.ssqa import SSQAHyperParams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problem", default="G11",
                    help="instance name (G11, G12, G13, King1, K2000)")
    ap.add_argument("--algo", choices=("ssa", "ssqa"), default="ssa",
                    help="algorithm family: 'ssqa' runs the Trotter-replica quantum "
                         "variant; the rings live on the trial axis, so --trials must "
                         "be a multiple of --replicas")
    ap.add_argument("--replicas", type=int, default=8,
                    help="--algo ssqa: Trotter replicas per ring (>= 2)")
    ap.add_argument("--jperp-max", type=int, default=4,
                    help="--algo ssqa: integer replica coupling at the coldest plateau")
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--m-shot", type=int, default=20)
    ap.add_argument("--tau", type=int, default=100)
    ap.add_argument("--i0-min", type=int, default=1)
    ap.add_argument("--i0-max", type=int, default=32)
    ap.add_argument("--n-rnd", type=int, default=2)
    ap.add_argument("--beta-shift", type=int, default=1)
    ap.add_argument("--storage", choices=("i0max", "all"), default="i0max")
    ap.add_argument("--storage-layout", choices=("dense", "packed"), default="dense",
                    help="inter-plateau spin state: int8 spins or 32-bit words "
                         "(bit-identical results)")
    ap.add_argument("--backend", choices=("sparse", "dense", "cuda"), default="sparse")
    ap.add_argument("--noise", choices=("xorshift", "threefry"), default="xorshift")
    ap.add_argument("--noise-mode", choices=("auto", "streamed", "pregen"), default="auto",
                    help="cuda backend: in-kernel xorshift noise (streamed) or a "
                         "per-plateau noise buffer (pregen); auto streams xorshift "
                         "and pregenerates threefry")
    ap.add_argument("--field-mode", choices=("dense", "popcount", "auto"), default="dense",
                    help="field arithmetic of the dense and cuda backends: 'popcount' "
                         "= XNOR-popcount on the coupling bitplanes (bit-identical "
                         "results); the sparse backend ignores it")
    ap.add_argument("--record", choices=("best", "traj"), default="best")
    ap.add_argument("--track-energy", action="store_true",
                    help="record per-cycle energy traces (the cycle loop)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    knobs = dict(n_trials=args.trials, m_shot=args.m_shot, n_rnd=args.n_rnd,
                 i0_min=args.i0_min, i0_max=args.i0_max, tau=args.tau,
                 beta_shift=args.beta_shift)
    if args.algo == "ssqa":
        hp = SSQAHyperParams(**knobs, n_replicas=args.replicas, jperp_max=args.jperp_max)
    else:
        hp = SSAHyperParams(**knobs)
    p = gset.load(args.problem)
    algo = ("SSQA" if args.algo == "ssqa"
            else "HA-SSA" if args.storage == "i0max" else "SSA")
    extra = (f"; R={hp.n_replicas} jperp_max={hp.jperp_max}"
             if args.algo == "ssqa" else "")
    print(f"{p.name}: N={p.n} |E|={len(p.edges)}; {hp.total_cycles} cycles "
          f"× {hp.n_trials} trials; backend={args.backend}; noise={args.noise}; "
          f"device={args.device}; "
          f"storage={args.storage} ({algo}){extra}")
    cfg = SolverConfig(backend=args.backend, storage_layout=args.storage_layout,
                       noise=args.noise, noise_mode=args.noise_mode,
                       field_mode=args.field_mode if args.backend != "sparse" else "auto")
    t0 = time.time()
    r = anneal(p, hp, seed=args.seed, storage=args.storage, record=args.record,
               config=cfg, track_energy=args.track_energy, device=args.device)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    spin_cycles = hp.total_cycles * hp.n_trials
    print(f"best cut {r.overall_best_cut}  avg {r.mean_best_cut:.1f}  "
          f"best energy {r.best_energy.min()}  ({dt:.1f}s, "
          f"{spin_cycles/dt:.0f} trial-cycles/s, "
          f"{spin_cycles*p.n/dt:.2e} spin-cycles/s)")
    if p.best_known:
        print(f"best known {p.best_known} → {100*r.overall_best_cut/p.best_known:.2f}%")
    print(f"trajectory memory/iter: {memory.hassa_bits_per_iteration(p.n, hp)} bits "
          f"(SSA would use {memory.ssa_bits_per_iteration(p.n, hp)}; "
          f"{memory.memory_ratio(hp)}× saving)")


if __name__ == "__main__":
    main()
