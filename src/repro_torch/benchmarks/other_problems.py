"""Problem-frontend sweep: every family end to end through the service.

The port's ``benchmarks/other_problems.py``.  Every family (QUBO, maximum
independent set, graph coloring, number partitioning) solves an instance
through :class:`repro_torch.serve.AnnealService` on each backend (sparse,
dense, cuda; ``field_mode='auto'`` where the backend has one, so the cuda
backend runs K1 or K2 by the weights' bit depth), decodes it, and the
family's feasibility verifier must accept it; the backends must agree on
the decoded objective (they are bit-identical).  ``hp='auto'`` must match
or beat the hand-set defaults on the G11 cut and the QUBO objective.
Exits 1 if a check fails.

    python -m repro_torch.benchmarks.other_problems --smoke --device cpu --json /tmp/p.json

The smoke cell also checks ``backend='auto'``'s rule against the port's own
``engine.MIN_RESIDENT_N`` (measured on the H100): a size just below it
resolves to the dense backend, the size itself to the CUDA kernels.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.core import gset
from repro_torch.core.ssa import SSAHyperParams
from repro_torch.problems import make_demo
from repro_torch.serve import AnnealRequest, AnnealService

from .common import emit

BACKENDS = ("sparse", "dense", "cuda")

# family → (smoke size, full size) in frontend units (see FAMILIES).
SIZES = {"qubo": (32, 96), "mis": (48, 128), "coloring": (36, 90), "partition": (24, 48)}


def _solve_one(backend, problem, hp, device, *, seed=0, auto_base=None):
    opts = {} if backend == "sparse" else {"field_mode": "auto"}
    svc = AnnealService(backend=backend, noise="xorshift", backend_opts=opts, device=device)
    req = AnnealRequest(problem=problem, hp=hp, seed=seed, auto_base=auto_base)
    t0 = time.perf_counter()
    resp = svc.solve([req])[0]
    return resp, time.perf_counter() - t0


def run(smoke: bool = False, json_path=None, csv_prefix: str = "problems", device=None):
    base = (SSAHyperParams(n_trials=4, m_shot=2) if smoke
            else SSAHyperParams(n_trials=16, m_shot=10))
    report = {"smoke": smoke, "families": {}, "acceptance": {}}
    failures = []
    for kind, (n_smoke, n_full) in SIZES.items():
        enc = make_demo(kind, n=n_smoke if smoke else n_full, seed=0)
        row = {"name": enc.model.name, "n_spins": enc.model.n, "backends": {}}
        objectives = {}
        for backend in BACKENDS:
            resp, wall = _solve_one(backend, enc, "auto", device, auto_base=base)
            rhp = resp.request.hp
            row["backends"][backend] = {"objective": resp.objective,
                                        "feasible": bool(resp.feasible), "wall_s": wall,
                                        "n_rnd": rhp.n_rnd, "i0_max": rhp.i0_max,
                                        "tau": rhp.tau}
            objectives[backend] = resp.objective
            emit(f"{csv_prefix}/{kind}/{backend}", wall * 1e6,
                 f"objective={resp.objective};feasible={resp.feasible};"
                 f"n_rnd={rhp.n_rnd};i0_max={rhp.i0_max}")
            if not resp.feasible:
                failures.append(f"{kind}/{backend}: decoded solution infeasible")
        row["backends_agree"] = len(set(objectives.values())) == 1
        if not row["backends_agree"]:
            failures.append(f"{kind}: backends disagree: {objectives}")
        report["families"][kind] = row

    g11 = gset.load("G11")
    hand, _ = _solve_one("sparse", g11, base, device)
    auto, _ = _solve_one("sparse", g11, "auto", device, auto_base=base)
    g11_row = {"hand_cut": int(hand.result.overall_best_cut),
               "auto_cut": int(auto.result.overall_best_cut),
               "auto_params": {"n_rnd": auto.request.hp.n_rnd,
                               "i0_max": auto.request.hp.i0_max,
                               "tau": auto.request.hp.tau}}
    emit(f"{csv_prefix}/acceptance/g11", 0.0,
         f"hand={g11_row['hand_cut']};auto={g11_row['auto_cut']}")
    if g11_row["auto_cut"] < g11_row["hand_cut"]:
        failures.append(f"G11: auto cut {g11_row['auto_cut']} < hand cut "
                        f"{g11_row['hand_cut']}")
    report["acceptance"]["g11"] = g11_row

    qenc = make_demo("qubo", n=SIZES["qubo"][0], seed=0)
    handq, _ = _solve_one("sparse", qenc, base, device)
    autoq, _ = _solve_one("sparse", qenc, "auto", device, auto_base=base)
    q_row = {"hand_objective": handq.objective, "auto_objective": autoq.objective}
    emit(f"{csv_prefix}/acceptance/qubo", 0.0,
         f"hand={q_row['hand_objective']};auto={q_row['auto_objective']}")
    if autoq.objective > handq.objective:  # minimization
        failures.append(f"qubo: auto objective {autoq.objective} > hand objective "
                        f"{handq.objective}")
    report["acceptance"]["qubo"] = q_row

    if smoke:
        # The resolver itself, gated: cheaper and steadier than re-timing it.
        from repro_torch.core.engine import MIN_RESIDENT_N, resolve_backend

        picked = {n: resolve_backend("auto", n) for n in (MIN_RESIDENT_N - 1, MIN_RESIDENT_N)}
        emit(f"{csv_prefix}/auto_backend", 0.0,
             f"n{MIN_RESIDENT_N - 1}={picked[MIN_RESIDENT_N - 1]};"
             f"n{MIN_RESIDENT_N}={picked[MIN_RESIDENT_N]};min_resident_n={MIN_RESIDENT_N}")
        if list(picked.values()) != ["dense", "cuda"]:
            failures.append(f"auto backend below / at MIN_RESIDENT_N={MIN_RESIDENT_N} resolved "
                            f"to {picked}, not dense / cuda")
        report["acceptance"]["auto_backend"] = picked
    report["failures"] = failures
    report["ok"] = not failures
    if json_path:
        with open(json_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {json_path}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true", help="reduced sizes and budgets")
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    rep = run(smoke=args.smoke, json_path=args.json, device=args.device)
    if not rep["ok"]:
        for f in rep["failures"]:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
