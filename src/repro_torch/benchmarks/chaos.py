"""Chaos suite: the annealing service under injected faults (port of the JAX
repo's ``benchmarks/chaos.py``).

The resilience layer's claims are worth stating only if they are measured:
this benchmark runs :class:`~repro_torch.serve.AnnealService` through every
fault class of the failure model, with the
:mod:`repro_torch.ft.faults` injector, and gates on the recovery contracts:

* **kill/resume** — a solve killed between chunks and resumed from its
  chunk checkpoints returns the uninterrupted run's best energies and
  spins bit for bit (sparse, dense and cuda backends, xorshift noise);
* **compile fallback** — an injected compile failure of the cuda backend
  completes on the cuda → dense chain, bit-identically, the downgrade on
  ``AnnealResponse.status`` and ``events``.  Only injected faults walk the
  chain: a real kernel build, launch or memory fault raises;
* **oom → tiled** — an injected dense-J out-of-memory fault re-enters as
  tiled J on the same backend, bit-identically;
* **nan quarantine** — a NaN burst on one batch slot quarantines only that
  request (solo retry) while its batchmate stays bit-exact;
* **deadline** — an expired deadline returns best-so-far with
  ``status='deadline'`` instead of raising;
* **chaos schedules** — seeded random fault plans
  (:func:`repro_torch.ft.faults.chaos_schedule`) all end in served
  responses, every result bit-identical to the fault-free run.

Writes ``BENCH_chaos.json``; exits 1 if a gate fails.  Runs on the GPU
unless ``--device cpu``.

    python -m repro_torch.benchmarks.chaos            # full sweep
    python -m repro_torch.benchmarks.chaos --smoke    # fewer seeds, small budgets
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

from repro_torch.core import gset
from repro_torch.core.ssa import SSAHyperParams
from repro_torch.ft.faults import FaultInjector, InjectedKill, chaos_schedule
from repro_torch.serve import AnnealRequest, AnnealService, ResiliencePolicy

from .common import emit

BACKENDS = ("sparse", "dense", "cuda")


def _problems(smoke):
    n = 36 if smoke else 100
    return (gset.toroidal_grid(n, seed=0, name=f"t{n}"), gset.king_graph(n, seed=3, name=f"k{n}"))


def _hp(smoke):
    return (SSAHyperParams(n_trials=3, m_shot=6, tau=4, i0_min=1, i0_max=8)
            if smoke else SSAHyperParams(n_trials=8, m_shot=10))


def _requests(problems, hp, **kw):
    return [AnnealRequest(problem=p, hp=hp, seed=i + 1, **kw) for i, p in enumerate(problems)]


def _bit_identical(a, b):
    return (np.array_equal(a.result.best_energy, b.result.best_energy)
            and np.array_equal(a.result.best_m, b.result.best_m))


def run(smoke: bool = False, json_path: str = "BENCH_chaos.json", csv_prefix: str = "chaos",
        device=None):
    problems, hp = _problems(smoke), _hp(smoke)

    def svc(backend, **kw):
        return AnnealService(backend=backend, min_bucket=16, device=device, **kw)

    def reqs(**kw):
        return _requests(problems, hp, **kw)

    failures = []
    report = {"smoke": smoke, "device": str(device or "cuda"), "scenarios": {}}
    baseline = {b: svc(b).solve(reqs()) for b in BACKENDS}

    # -- kill at a chunk boundary, resume from checkpoints ---------------
    for backend in BACKENDS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            pol = ResiliencePolicy(checkpoint_dir=d)
            inj = FaultInjector()
            inj.arm("kill", chunk=2)
            killed = False
            try:
                svc(backend, resilience=pol, faults=inj).solve(reqs())
            except InjectedKill:
                killed = True
            resumed = svc(backend, resilience=pol).solve(reqs())
        identical = all(_bit_identical(a, b) for a, b in zip(baseline[backend], resumed))
        resumed_from = [e.detail.get("chunk") for r in resumed for e in r.events
                        if e.kind == "resume"]
        ok = killed and identical and bool(resumed_from)
        report["scenarios"][f"kill_resume_{backend}"] = {
            "killed": killed, "bit_identical": identical,
            "resumed_from_chunk": resumed_from[:1], "ok": ok}
        emit(f"{csv_prefix}/kill_resume/{backend}", (time.perf_counter() - t0) * 1e6,
             f"bit_identical={identical}")
        if not ok:
            failures.append(f"kill_resume[{backend}]: killed={killed} "
                            f"bit_identical={identical} resume={resumed_from}")

    # -- injected compile failure of the cuda backend → fallback chain ---
    inj = FaultInjector()
    inj.arm("compile", backend="cuda")
    t0 = time.perf_counter()
    resp = svc("cuda", faults=inj).solve(reqs())
    hops = [(e.detail["from"], e.detail["to"]) for e in resp[0].events if e.kind == "fallback"]
    identical = all(_bit_identical(a, b) for a, b in zip(baseline["cuda"], resp))
    ok = (all(r.status == "fallback" for r in resp) and hops == [("cuda", "dense")]
          and identical)
    report["scenarios"]["compile_fallback"] = {
        "statuses": [r.status for r in resp], "hops": hops, "bit_identical": identical,
        "ok": ok}
    emit(f"{csv_prefix}/compile_fallback", (time.perf_counter() - t0) * 1e6, f"hops={hops}")
    if not ok:
        failures.append(f"compile_fallback: statuses={[r.status for r in resp]} hops={hops} "
                        f"bit_identical={identical}")

    # -- injected dense-J out of memory → tiled-J downgrade --------------
    inj = FaultInjector()
    inj.arm("oom", backend="dense", j_mode="dense")
    t0 = time.perf_counter()
    resp = svc("dense", faults=inj).solve(reqs())
    to_opts = [e.detail["to_opts"] for e in resp[0].events if e.kind == "fallback"]
    identical = all(_bit_identical(a, b) for a, b in zip(baseline["dense"], resp))
    ok = bool(all(r.status == "fallback" for r in resp) and identical and to_opts
              and to_opts[0].get("j_mode") == "tiled")
    report["scenarios"]["oom_tiled"] = {
        "statuses": [r.status for r in resp], "to_opts": to_opts,
        "bit_identical": identical, "ok": ok}
    emit(f"{csv_prefix}/oom_tiled", (time.perf_counter() - t0) * 1e6, f"to_opts={to_opts}")
    if not ok:
        failures.append(f"oom_tiled: to_opts={to_opts} bit_identical={identical}")

    # -- NaN burst → quarantine, batchmate bit-exact ---------------------
    inj = FaultInjector()
    inj.arm("nan", chunk=1, slots=(1,))
    t0 = time.perf_counter()
    resp = svc("sparse", faults=inj).solve(reqs())
    mate_exact = _bit_identical(baseline["sparse"][0], resp[0])
    ok = (resp[0].status == "ok" and mate_exact and resp[1].status == "quarantined"
          and resp[1].result is not None)
    report["scenarios"]["nan_quarantine"] = {
        "statuses": [r.status for r in resp], "batchmate_bit_exact": mate_exact, "ok": ok}
    emit(f"{csv_prefix}/nan_quarantine", (time.perf_counter() - t0) * 1e6,
         f"statuses={[r.status for r in resp]}")
    if not ok:
        failures.append(f"nan_quarantine: statuses={[r.status for r in resp]} "
                        f"batchmate_exact={mate_exact}")

    # -- deadline expiry → best-so-far, never raises ---------------------
    t0 = time.perf_counter()
    resp = svc("sparse").solve(reqs(deadline_s=1e-9))
    ok = (all(r.status == "deadline" for r in resp) and all(r.result is not None for r in resp)
          and all(r.chunks_run < r.chunks_total for r in resp))
    report["scenarios"]["deadline"] = {
        "statuses": [r.status for r in resp],
        "chunks": [(r.chunks_run, r.chunks_total) for r in resp], "ok": ok}
    emit(f"{csv_prefix}/deadline", (time.perf_counter() - t0) * 1e6,
         f"chunks={[r.chunks_run for r in resp]}")
    if not ok:
        failures.append(f"deadline: statuses={[r.status for r in resp]}")

    # -- seeded chaos schedules ------------------------------------------
    n_seeds = 6 if smoke else 24
    survived = 0
    t0 = time.perf_counter()
    for seed in range(n_seeds):
        with tempfile.TemporaryDirectory() as d:
            pol = ResiliencePolicy(checkpoint_dir=d)
            try:
                resp = svc("cuda", resilience=pol, faults=chaos_schedule(seed)).solve(reqs())
            except InjectedKill:
                resp = svc("cuda", resilience=pol).solve(reqs())
            # A quarantined response was retried with a re-autotuned I0max:
            # another valid run, exempt from bit-identity.
            good = all((r.result is not None if r.status == "quarantined"
                        else _bit_identical(b, r))
                       for b, r in zip(baseline["cuda"], resp))
            survived += bool(good and len(resp) == len(problems))
    ok = survived == n_seeds
    report["scenarios"]["chaos_schedules"] = {"seeds": n_seeds, "survived": survived, "ok": ok}
    emit(f"{csv_prefix}/chaos_schedules", (time.perf_counter() - t0) * 1e6,
         f"survived={survived}/{n_seeds}")
    if not ok:
        failures.append(f"chaos_schedules: survived {survived}/{n_seeds}")

    report["failures"] = failures
    report["ok"] = not failures
    if json_path:
        with open(json_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {json_path}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true", help="fewer chaos seeds, smaller budgets")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--json", default="BENCH_chaos.json")
    args = ap.parse_args(argv)
    rep = run(smoke=args.smoke, json_path=args.json, device=args.device)
    if not rep["ok"]:
        for f in rep["failures"]:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
