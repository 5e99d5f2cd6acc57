"""Annealing launcher of the PyTorch port.

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
Runs on the GPU unless ``--device cpu`` is given.  ``--backend auto`` runs
cuda from ``engine.MIN_RESIDENT_N`` spins on and dense below (per shape
bucket in service and stream modes).

    python -m repro_torch.launch.anneal --problem K2000 --backend cuda \
        --algo ssqa --trials 96 --replicas 8 --jperp-max 4 --m-shot 10

Service mode: a comma-separated ``--problem`` (or ``--service``) routes the
batch through :class:`repro_torch.serve.AnnealService` — bucketed, stacked
on a problem axis, one cached program per shape bucket (on ``--backend
cuda`` one kernel launch per plateau or chain for the whole bucket), with
per-chunk progress lines, ``--target-cut`` early stop, ``--deadline-s`` and
the fallback chain cuda → dense → sparse on injected faults and dense-J →
tiled-J on the dense backend's out-of-memory faults (``--no-fallback``
turns it off); a real kernel fault of ``--backend cuda`` raises.
``--auto-tune`` replaces the Table II hyper-parameters with the
local-field determination in both modes.

    python -m repro_torch.launch.anneal --problem G11,G12,G13,King1 \
        --backend cuda --trials 100 --m-shot 10 --chunk-shots 5

``--checkpoint-dir DIR`` (service mode, or stream mode) saves every group's
state at each chunk boundary under DIR: a killed run, started again with
the same flags, resumes from its last boundary, bit-identically.

Streaming mode: ``--stream`` submits the problem list to the
continuously batched front door (:class:`repro_torch.serve.
StreamingAnnealService`) instead of one ``solve()`` batch: slot tables of
``--stream-slots`` lanes, one chunk per scheduling quantum, retired slots
backfilled at chunk boundaries; ``--arrival-rate`` paces the submissions
as an open-loop client, ``--priority`` picks the admission class.

    python -m repro_torch.launch.anneal --problem G11,G12,G13,King1,K2000 \
        --stream --backend cuda --trials 100 --m-shot 10 --stream-slots 4

Problem families: ``--problem-kind qubo|mis|coloring|partition`` builds
``--count`` demo instances of that family (``--problem-n`` spins, seeds
``--seed``, ``--seed``+1, …) and solves them through the service, printing
each one's decoded objective and feasibility.

    python -m repro_torch.launch.anneal --problem-kind mis --problem-n 2000 \
        --count 2 --backend cuda --field-mode auto --trials 100 --m-shot 10

Spin sharding: ``--partition spin`` shards the spin axis of each problem
over the ranks of a process group (``--partition auto`` per instance or
bucket); ``--mesh-shape P`` asks for P ranks, which ``torchrun`` starts,
one process each (NCCL on the GPU, one GPU per rank; gloo with ``--device
cpu``).  Every rank runs the same solve and rank 0 prints.  Needs
``--noise xorshift`` (the default).

    torchrun --nproc-per-node 2 -m repro_torch.launch.anneal --problem K2000 \
        --partition spin --backend dense --field-mode popcount
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch.core import gset, memory
from repro_torch.core.autotune import autotune_hyperparams
from repro_torch.core.config import SolverConfig
from repro_torch.core.ssa import SSAHyperParams, anneal
from repro_torch.core.ssqa import SSQAHyperParams


def _resilience_policy(args):
    from repro_torch.serve import ResiliencePolicy

    return ResiliencePolicy(checkpoint_dir=args.checkpoint_dir, fallback=not args.no_fallback)


def _backend_opts(args):
    """--field-mode reaches the field-capable backends; sparse ignores it."""
    if args.field_mode != "dense" and args.backend != "sparse":
        return {"field_mode": args.field_mode}
    return {}


def _partition_mesh(args):
    """(partition, mesh) from --partition and --mesh-shape; no mesh is made
    for partition='problem'."""
    if args.partition == "problem":
        return "problem", None
    from repro_torch.launch.mesh import make_spin_mesh

    return args.partition, make_spin_mesh(args.mesh_shape, device=args.device)


def _service(args):
    """The AnnealService the service and stream modes share."""
    from repro_torch.serve import AnnealService

    opts = _backend_opts(args)
    if args.noise_mode != "auto" and args.backend in ("cuda", "auto"):
        opts["noise_mode"] = args.noise_mode
    return AnnealService(backend=args.backend, noise=args.noise,
                         storage_layout=args.storage_layout, chunk_shots=args.chunk_shots,
                         backend_opts=opts, resilience=_resilience_policy(args),
                         partition=args.partition, mesh=args.mesh, device=args.device)


def _request(p, i, hp, args):
    from repro_torch.serve import AnnealRequest

    return AnnealRequest(problem=p, hp="auto" if args.auto_tune else hp, seed=args.seed + i,
                         storage=args.storage, target_cut=args.target_cut, auto_base=hp,
                         deadline_s=args.deadline_s, algo=args.algo)


def _run_service(problem_names, hp, args):
    problems = [gset.load(name) for name in problem_names]
    requests = [_request(p, i, hp, args) for i, p in enumerate(problems)]
    svc = _service(args)

    def progress(ev):
        bests = ", ".join(f"{problems[i].name}={b}"
                          for i, b in zip(ev.request_indices, ev.best_cut))
        print(f"[chunk {ev.chunk + 1}/{ev.chunks_total} bucket={ev.bucket}] "
              f"best cut: {bests}")

    t0 = time.time()
    responses = svc.solve(requests, progress=progress)
    if svc.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total_spin_cycles = 0
    for p, r in zip(problems, responses):
        if r.result is None:
            print(f"{p.name}: {r.status.upper()} — no result "
                  f"({'; '.join(e.kind for e in r.events) or 'no events'})")
            continue
        rhp = r.request.hp  # resolved (an autotuned hp differs from the base)
        shots = r.chunks_run * (rhp.m_shot // r.chunks_total)
        total_spin_cycles += shots * rhp.cycles_per_iter * rhp.n_trials * p.n
        tuned = (f" auto[n_rnd={rhp.n_rnd} i0_max={rhp.i0_max} tau={rhp.tau}]"
                 if r.autotune else "")
        degraded = "" if r.status == "ok" else f" status={r.status}"
        print(f"{p.name}: best cut {r.result.overall_best_cut} "
              f"avg {r.result.mean_best_cut:.1f} "
              f"[bucket={r.bucket} batch={r.batch} "
              f"chunks={r.chunks_run}/{r.chunks_total}]{tuned}{degraded}")
        for ev in r.events:
            print(f"  event[{ev.t:.2f}s] {ev.kind}: {ev.detail}")
    info = svc.cache_info()
    print(f"batch of {len(problems)} in {dt:.1f}s "
          f"({total_spin_cycles/dt:.2e} aggregate spin-cycles/s; "
          f"{info['programs']} compiled program(s), "
          f"{info.get('traces_chunk', 0)} plateau-program trace(s))")


def _run_stream(problem_names, hp, args):
    """Streaming client mode: submit the problem list to an always-on
    StreamingAnnealService, paced as an open-loop arrival process if asked,
    and wait for the tickets."""
    from repro_torch.serve import StreamingAnnealService, StreamPolicy

    problems = [gset.load(name) for name in problem_names]
    svc = _service(args)
    ss = StreamingAnnealService(service=svc,
                                policy=StreamPolicy(slots_per_table=args.stream_slots))
    ss.start()
    t0 = time.time()
    tickets = []
    try:
        for i, p in enumerate(problems):
            if args.arrival_rate > 0 and i:
                time.sleep(1.0 / args.arrival_rate)
            tickets.append(ss.submit(_request(p, i, hp, args), priority=args.priority))
        shed = deadline = 0
        for p, t in zip(problems, tickets):
            r = t.result(timeout=None)
            if r.status == "shed":
                # Dropped unstarted (its deadline was already unmeetable):
                # not a solver failure, counted apart in the summary.
                shed += 1
                print(f"{p.name}: SHED — dropped from the queue unstarted "
                      f"(deadline_s={r.request.deadline_s})")
                continue
            if r.result is None:
                print(f"{p.name}: {r.status.upper()} — no result "
                      f"({'; '.join(e.kind for e in r.events) or 'no events'})")
                continue
            if r.status == "deadline":
                deadline += 1
            print(f"{p.name}: best cut {r.result.overall_best_cut} "
                  f"[chunks={r.chunks_run}/{r.chunks_total} "
                  f"queued {r.queued_s:.2f}s lane {r.lane_wall_s:.2f}s] "
                  f"status={r.status}"
                  + (" (best-so-far at deadline)" if r.status == "deadline" else ""))
    finally:
        ss.stop()
    dt = time.time() - t0
    st = ss.stream_stats()
    print(f"stream of {len(problems)} in {dt:.1f}s: "
          f"occupancy={st['occupancy']:.2f} "
          f"backfills={st['stream_backfills']} "
          f"tables={st['stream_tables_created']} "
          f"quanta={st['stream_quanta']} "
          f"shed={shed} deadline={deadline}")


def _run_problem_kind(hp, args):
    """Demo instances of a problem family through the service."""
    from repro_torch.problems import make_demo
    from repro_torch.serve import AnnealRequest

    encs = [make_demo(args.problem_kind, n=args.problem_n, seed=args.seed + i)
            for i in range(args.count)]
    requests = [AnnealRequest(problem=enc, hp="auto" if args.auto_tune else hp,
                              seed=args.seed + i, storage=args.storage, auto_base=hp)
                for i, enc in enumerate(encs)]
    svc = _service(args)
    t0 = time.time()
    responses = svc.solve(requests)
    dt = time.time() - t0
    for enc, r in zip(encs, responses):
        if r.result is None:
            print(f"{enc.model.name}: {r.status.upper()} — no result "
                  f"({'; '.join(e.kind for e in r.events) or 'no events'})")
            continue
        rhp = r.request.hp
        tuned = (f" auto[n_rnd={rhp.n_rnd} i0_max={rhp.i0_max} tau={rhp.tau}]"
                 if r.autotune else "")
        degraded = "" if r.status == "ok" else f" status={r.status}"
        print(f"{enc.model.name}: objective={r.objective} feasible={r.feasible} "
              f"energy={int(r.result.best_energy.min())} "
              f"[bucket={r.bucket} batch={r.batch}]{tuned}{degraded}")
    print(f"{len(encs)} × {args.problem_kind} in {dt:.1f}s "
          f"({svc.cache_info()['programs']} compiled program(s))")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--problem", default="G11",
                    help="instance name (G11, G12, G13, King1, K2000, G77, G81), or a "
                         "comma list for service mode")
    ap.add_argument("--service", action="store_true",
                    help="route through the AnnealService even for one problem")
    ap.add_argument("--chunk-shots", type=int, default=1,
                    help="service mode: iterations per progress chunk")
    ap.add_argument("--target-cut", type=int, default=None,
                    help="service mode: early-stop once every request reaches it")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="service mode: per-request wall-clock budget; expiry returns "
                         "best-so-far with status='deadline'")
    ap.add_argument("--no-fallback", action="store_true",
                    help="service mode: no backend fallback chain (cuda → dense → "
                         "sparse); faults propagate instead")
    ap.add_argument("--auto-tune", action="store_true",
                    help="derive n_rnd, I0 and tau from the local-field distribution "
                         "instead of the Table II flags")
    ap.add_argument("--stream", action="store_true",
                    help="streaming client mode: submit the problem list to the "
                         "continuously batched StreamingAnnealService instead of one "
                         "solve() batch")
    ap.add_argument("--stream-slots", type=int, default=4,
                    help="--stream: slot-table width (a power of two)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="--stream: pace submissions at this rate in requests/s "
                         "(0 = submit everything at once)")
    ap.add_argument("--priority", choices=("interactive", "batch"), default="batch",
                    help="--stream: admission priority class")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="chunk-level checkpoint root (implies service mode unless "
                         "--stream): a killed run resumes bit-identically")
    ap.add_argument("--problem-kind", default="gset",
                    choices=("gset", "qubo", "mis", "coloring", "partition"),
                    help="problem family: 'gset' uses --problem names; the others solve "
                         "demo instances through the service")
    ap.add_argument("--problem-n", type=int, default=0,
                    help="demo instance size for non-gset kinds (0 = family default)")
    ap.add_argument("--count", type=int, default=1,
                    help="number of demo instances for non-gset kinds")
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
    ap.add_argument("--backend", choices=("sparse", "dense", "cuda", "auto"), default="sparse",
                    help="'auto' picks cuda at/above MIN_RESIDENT_N spins, dense below "
                         "(the small-N launch-overhead rule)")
    ap.add_argument("--noise", choices=("xorshift", "threefry"), default="xorshift")
    ap.add_argument("--noise-mode", choices=("auto", "streamed", "pregen"), default="auto",
                    help="cuda backend: in-kernel xorshift noise (streamed) or a "
                         "per-plateau noise buffer (pregen); auto streams xorshift "
                         "and pregenerates threefry")
    ap.add_argument("--field-mode", choices=("dense", "popcount", "auto"), default="dense",
                    help="field arithmetic of the dense and cuda backends: 'popcount' "
                         "= XNOR-popcount on the coupling bitplanes (bit-identical "
                         "results); the sparse backend ignores it")
    ap.add_argument("--partition", choices=("problem", "spin", "auto"), default="problem",
                    help="work partitioning: 'spin' shards the spin axis of each problem "
                         "over the ranks of a process group (bit-identical results), "
                         "'auto' picks per instance or bucket")
    ap.add_argument("--mesh-shape", default=None,
                    help="rank count for --partition spin|auto, e.g. '2' (default: every "
                         "rank); more than one needs torchrun --nproc-per-node")
    ap.add_argument("--record", choices=("best", "traj"), default="best")
    ap.add_argument("--track-energy", action="store_true",
                    help="record per-cycle energy traces (the cycle loop)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    args.partition, args.mesh = _partition_mesh(args)
    if args.mesh is not None and args.mesh.rank:
        # Every rank solves alike; rank 0 alone prints.
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            return _main(args)
    return _main(args)


def _main(args):
    knobs = dict(n_trials=args.trials, m_shot=args.m_shot, n_rnd=args.n_rnd,
                 i0_min=args.i0_min, i0_max=args.i0_max, tau=args.tau,
                 beta_shift=args.beta_shift)
    if args.algo == "ssqa":
        hp = SSQAHyperParams(**knobs, n_replicas=args.replicas, jperp_max=args.jperp_max)
    else:
        hp = SSAHyperParams(**knobs)
    if args.problem_kind != "gset":
        return _run_problem_kind(hp, args)
    names = args.problem.split(",")
    if args.stream:
        return _run_stream(names, hp, args)
    if args.service or len(names) > 1 or args.checkpoint_dir is not None:
        return _run_service(names, hp, args)

    p = gset.load(args.problem)
    if args.auto_tune:
        hp, rep = autotune_hyperparams(p.to_ising(), hp)
        print(f"auto-tune: sigma={rep.sigma:.2f} |z|max={rep.z_max} → "
              f"n_rnd={hp.n_rnd} I0:{hp.i0_min}→{hp.i0_max} tau={hp.tau}")
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
                       field_mode=args.field_mode if args.backend != "sparse" else "auto",
                       partition=args.partition, mesh=args.mesh)
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
