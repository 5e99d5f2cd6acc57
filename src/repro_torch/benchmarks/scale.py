"""Weak scaling of the spin-sharded annealer (port of the JAX repo's
``benchmarks/scale.py``).

One instance sharded over P ranks at a fixed spin count per rank (N = P ×
``n_per_rank``): its steady-state spin-cycles/s, the busiest rank's
resident bytes at that N and at a fixed bucket (the residency drop), and
the largest-N row — an instance above ``engine.MAX_UNSHARDED_SPINS`` that
the problem-partitioned service rejects at admission and the spin-sharded
service solves end to end.  Every row first asserts that the sharded runs
equal the single-device runs, for the float32 tiled field and the
XNOR-popcount field: the numbers count only because the answers are equal.

The parent spawns the P ranks of each row, joined through a ``file://``
rendezvous: gloo ranks on the CPU (``--device cpu``), one NCCL rank per GPU
on the card.  Rank 0 prints the row; the parent writes ``BENCH_scale.json``.

    python -m repro_torch.benchmarks.scale --smoke --device cpu --ranks 1,2,4
    python -m repro_torch.benchmarks.scale --ranks 1          # one H100: P = 1
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SMOKE = {"n_per_rank": 512, "n_trials": 2, "tau": 4, "i0_max": 4, "resid_n": 4096,
         "big_n": 40000, "big_hp": dict(n_trials=1, m_shot=1, tau=2, i0_min=1, i0_max=2)}
FULL = {"n_per_rank": 4096, "n_trials": 4, "tau": 16, "i0_max": 8, "resid_n": 4096,
        "big_n": 40000, "big_hp": dict(n_trials=2, m_shot=1, tau=4, i0_min=1, i0_max=4)}


def _sync(mesh):
    import torch

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    mesh.barrier()


def _dist_backend(device: str) -> str:
    """NCCL, one rank per GPU, on the card; gloo on the CPU."""
    return "nccl" if device.startswith("cuda") else "gloo"


def _worker(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import gset, memory
    from repro_torch.core.config import SolverConfig
    from repro_torch.core.engine import (
        MAX_UNSHARDED_SPINS,
        make_backend,
        make_batched_backend,
        run_schedule,
        schedule_plateaus,
    )
    from repro_torch.core.ssa import SSAHyperParams, anneal
    from repro_torch.sharding import spin_mesh

    cfg = json.loads(args.cfg)
    backend = _dist_backend(args.device)
    if backend == "nccl":
        torch.cuda.set_device(args.rank)
    dist.init_process_group(backend, init_method=f"file://{args.store}",
                            rank=args.rank, world_size=args.world)
    mesh = spin_mesh(args.world, device=args.device)
    P = mesh.size
    out = {"ranks": P, "dist_backend": mesh.backend, "device": str(mesh.device)}

    # -- equality first: sharded == single device, both field arithmetics --
    small = gset.toroidal_grid(1024, seed=7, name="bitid")
    hp_id = SSAHyperParams(n_trials=2, m_shot=2, tau=3, i0_min=1, i0_max=4)
    same = {}
    for label, field in (("tiled", "dense"), ("popcount", "popcount")):
        kw = dict(seed=3, track_energy=False, device=mesh.device)
        ref = anneal(small, hp_id, config=SolverConfig(backend="dense", noise="xorshift",
                                                       j_mode="tiled", field_mode=field), **kw)
        sh = anneal(small, hp_id, config=SolverConfig(backend="dense", noise="xorshift",
                                                      field_mode=field, partition="spin",
                                                      mesh=mesh), **kw)
        same[label] = bool(np.array_equal(ref.best_energy, sh.best_energy)
                           and np.array_equal(ref.best_m, sh.best_m))
    out["bit_identity"] = same
    if not all(same.values()):
        raise SystemExit(f"scale: sharded != single-device at P={P}: {same}")

    # -- weak scaling: N = P * n_per_rank ----------------------------------
    n = P * cfg["n_per_rank"]
    model = gset.toroidal_grid(n, seed=11, name=f"scale{n}").to_ising()
    hp = SSAHyperParams(n_trials=cfg["n_trials"], m_shot=1, tau=cfg["tau"], i0_min=1,
                        i0_max=cfg["i0_max"])
    plateaus = schedule_plateaus(hp.schedule("hassa"))
    cycles = sum(p.length for p in plateaus)
    bk = make_backend("dense", model, n_trials=hp.n_trials, n_rnd=hp.n_rnd, noise="xorshift",
                      partition="spin", mesh=mesh, device=mesh.device)
    state = bk.init_state(0)
    out["n"] = n
    out["max_device_bytes"] = memory.max_device_bytes((bk._problem, state), mesh)
    run_schedule(bk, plateaus, state)  # warm-up
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(3):
        run_schedule(bk, plateaus, state)
    _sync(mesh)
    us = (time.perf_counter() - t0) / 3 * 1e6
    out["wall_us"] = us
    out["spin_cycles_per_s"] = cycles * hp.n_trials * n / (us * 1e-6)

    # -- residency at a fixed bucket: what each rank holds -----------------
    rb = make_batched_backend("dense", n_bucket=cfg["resid_n"], n_trials=2, noise="xorshift",
                              partition="spin", mesh=mesh, device=mesh.device)
    prob = rb.stack([small.to_ising()])
    st = rb.init_state(prob, rb.init_noise([0], [small.n]))
    out["resid_n"] = cfg["resid_n"]
    out["max_device_bytes_fixed_n"] = memory.max_device_bytes((prob, st), mesh)

    # -- largest-N row: rejected unsharded, solved spin-sharded ------------
    if args.big_n:
        from repro_torch.serve import AdmissionError, AnnealRequest, AnnealService

        big = gset.toroidal_grid(args.big_n, seed=5, name="bigN")
        assert big.n > MAX_UNSHARDED_SPINS
        req = AnnealRequest(problem=big, hp=SSAHyperParams(**cfg["big_hp"]), seed=1)
        try:
            AnnealService(backend="sparse", device=mesh.device).solve([req])
            rejected = False
        except AdmissionError:
            rejected = True
        t0 = time.perf_counter()
        resp = AnnealService(backend="sparse", partition="spin", mesh=mesh).solve([req])[0]
        out["largest_n"] = {"n": int(big.n), "bucket": int(resp.bucket),
                            "single_device_rejected": rejected, "status": resp.status,
                            "best_cut": int(np.max(resp.result.best_cut)),
                            "wall_s": time.perf_counter() - t0}
    if mesh.rank == 0:
        print("RESULT_JSON:" + json.dumps(out), flush=True)
    dist.destroy_process_group()


def spawn_ranks(world: int, argv, *, device: str, timeout: float):
    """Run ``python -m repro_torch.benchmarks.scale --worker`` as ``world``
    ranks joined through a ``file://`` rendezvous; returns rank 0's stdout.
    Every rank is waited for (or killed at the time limit)."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (src, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.benchmarks.scale", "--worker",
             "--rank", str(r), "--world", str(world), "--store", store,
             "--device", device, *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode, e[-2000:]) for r, (p, (_, e)) in enumerate(zip(procs, outs))
           if p.returncode]
    if bad:
        raise RuntimeError(f"scale: ranks failed: {bad}")
    return outs[0][0]


def run(ranks, *, smoke: bool, device: str, json_path: str, timeout: float = 1800):
    from .common import emit

    cfg = SMOKE if smoke else FULL
    rows = []
    for P in ranks:
        big_n = cfg["big_n"] if P == max(ranks) else 0
        out = spawn_ranks(P, ["--cfg", json.dumps(cfg), "--big-n", str(big_n)],
                          device=device, timeout=timeout)
        row = next(json.loads(line[len("RESULT_JSON:"):]) for line in out.splitlines()
                   if line.startswith("RESULT_JSON:"))
        rows.append(row)
        emit(f"scale/P{P}/n{row['n']}", row["wall_us"],
             f"scs={row['spin_cycles_per_s']:.3e};max_dev_bytes={row['max_device_bytes']};"
             f"bytes@{row['resid_n']}={row['max_device_bytes_fixed_n']};"
             f"bit_identity={all(row['bit_identity'].values())}")
    base = rows[0]
    for row in rows:
        row["weak_scaling_speedup"] = row["spin_cycles_per_s"] / base["spin_cycles_per_s"]
        row["residency_drop"] = base["max_device_bytes_fixed_n"] / row["max_device_bytes_fixed_n"]
    big = next((r["largest_n"] for r in rows if "largest_n" in r), None)
    report = {"smoke": smoke, "device": device, "dist_backend": _dist_backend(device),
              "weak_scaling": rows, "largest_n": big}
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)
    if big is not None:
        emit("scale/largest_n", big["wall_s"] * 1e6,
             f"n={big['n']};rejected_unsharded={big['single_device_rejected']};"
             f"status={big['status']}")
        if not big["single_device_rejected"] or big["status"] != "ok":
            raise SystemExit(f"scale: largest-N row failed: {big}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true", help="small sizes")
    ap.add_argument("--ranks", default="1", help="comma list of rank counts, e.g. 1,2,4")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="BENCH_scale.json")
    for flag in ("--worker",):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag, typ in (("--rank", int), ("--world", int), ("--store", str), ("--cfg", str),
                      ("--big-n", int)):
        ap.add_argument(flag, type=typ, default=0 if typ is int else "",
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args)
    run([int(p) for p in args.ranks.split(",")], smoke=args.smoke, device=args.device,
        json_path=args.json)


if __name__ == "__main__":
    main()
