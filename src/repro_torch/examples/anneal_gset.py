"""End-to-end annealing driver: solve the benchmark set with HA-SSA through
the service, beside the SA baseline, as the paper compares them.

    PYTHONPATH=src python -m repro_torch.examples.anneal_gset \
        [--full] [--problems G11,King1] [--backend sparse|dense|cuda] [--device cpu]

``--full`` uses the paper's scale (100 trials × 90,000 cycles).  The HA-SSA
solves go through :func:`solve_batch`, a thin client of
:class:`repro_torch.serve.AnnealService`: same-bucket requests are stacked
and solved together (on ``--backend cuda`` one kernel launch per plateau
for the whole bucket).  SA (:func:`repro_torch.core.sa.anneal_sa`) runs at
the same cycle budget.  ``--stream-demo`` replays a mixed G-set and QUBO
trace through the streaming front door instead.  Runs on the GPU unless
``--device cpu`` is given.
"""
import argparse
import time
from typing import List, Optional

from repro_torch.core import gset
from repro_torch.core.sa import SAHyperParams, anneal_sa
from repro_torch.core.ssa import SSAHyperParams
from repro_torch.serve import AnnealRequest, AnnealResponse, AnnealService


def solve_batch(requests: List[AnnealRequest], *, backend: str = "sparse",
                noise: str = "xorshift", service: Optional[AnnealService] = None,
                progress=None, device=None) -> List[AnnealResponse]:
    """Solve a batch of requests on one annealing service (one program per
    shape bucket, cached across calls when ``service`` is reused)."""
    service = service or AnnealService(backend=backend, noise=noise, device=device)
    return service.solve(requests, progress=progress)


def stream_demo(backend: str = "sparse", full: bool = False, device=None):
    """Continuous batching: three batch-priority QUBOs first, then two
    interactive G-set requests, which the scheduler seats ahead of the
    remaining batch queue; every lane retires at its own chunk boundary."""
    from repro_torch.problems import make_demo
    from repro_torch.serve import StreamingAnnealService, StreamPolicy

    hp = SSAHyperParams(n_trials=16 if full else 4, m_shot=30 if full else 6, tau=8,
                        i0_min=1, i0_max=16)
    ss = StreamingAnnealService(backend=backend, min_bucket=64, device=device,
                                policy=StreamPolicy(slots_per_table=2))
    t0 = time.time()
    tickets = [("batch", ss.submit(AnnealRequest(problem=make_demo("qubo", n=96, seed=i),
                                                 hp=hp, seed=i), priority="batch"))
               for i in range(3)]
    tickets += [("interactive", ss.submit(AnnealRequest(problem=gset.load(name), hp=hp, seed=7),
                                          priority="interactive"))
                for name in ("G11", "King1")]
    print(f"submitted {len(tickets)} requests (3 batch QUBOs first, 2 interactive G-set last)")
    ss.run_until_idle()
    for prio, t in tickets:
        r = t.result(timeout=0)
        name = getattr(t.request.problem, "name", None) or t.request.problem.model.name
        if r.result is None:
            print(f"  [{prio:11s}] {name}: {r.status.upper()} — no result")
            continue
        best = r.objective if r.objective is not None else r.result.overall_best_cut
        print(f"  [{prio:11s}] {name}: best {best} (queued {r.queued_s:.2f}s, "
              f"lane {r.lane_wall_s:.2f}s, status={r.status})")
    st = ss.stream_stats()
    print(f"stream drained in {time.time() - t0:.1f}s: occupancy={st['occupancy']:.2f} "
          f"backfills={st['stream_backfills']} tables={st['stream_tables_created']} "
          f"quanta={st['stream_quanta']}")


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--problems", default="G11,G12,G13,King1")
    ap.add_argument("--backend", choices=("sparse", "dense", "cuda"), default="sparse")
    ap.add_argument("--skip-sa", action="store_true", help="skip the SA baseline")
    ap.add_argument("--stream-demo", action="store_true",
                    help="replay a mixed G-set + QUBO trace through the streaming service")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.stream_demo:
        return stream_demo(backend=args.backend, full=args.full, device=args.device)

    trials = 100 if args.full else 8
    hp = SSAHyperParams(n_trials=trials, m_shot=150 if args.full else 15)
    problems = [gset.load(name) for name in args.problems.split(",")]
    responses = solve_batch([AnnealRequest(problem=p, hp=hp) for p in problems],
                            backend=args.backend, device=args.device)
    for p, resp in zip(problems, responses):
        r_ha = resp.result
        print(f"\n=== {p.name} (N={p.n}, |E|={len(p.edges)}) {hp.total_cycles} cycles x "
              f"{trials} trials [backend={args.backend} bucket={resp.bucket} "
              f"batch={resp.batch}] ===")
        print(f"  HA-SSA: best {r_ha.overall_best_cut}  avg {r_ha.mean_best_cut:.1f}  "
              f"({resp.wall_s:.1f}s batch)")
        if not args.skip_sa:
            t0 = time.time()
            r_sa = anneal_sa(p, SAHyperParams(n_trials=trials, n_cycles=hp.total_cycles),
                             seed=0, device=args.device)
            print(f"  SA    : best {r_sa.overall_best_cut}  avg {r_sa.mean_best_cut:.1f}  "
                  f"({time.time() - t0:.1f}s)")
        if p.best_known:
            print(f"  best known: {p.best_known} "
                  f"(HA-SSA at {100 * r_ha.overall_best_cut / p.best_known:.1f}%)")


if __name__ == "__main__":
    main()
