"""Open-loop goodput benchmark: streaming against drain-the-bucket serving
(port of the JAX repo's ``benchmarks/serve_stream.py``).

Continuous batching earns its place only if it moves the serving curves, so
this benchmark replays one open-loop arrival trace — compound Poisson:
bursts of requests at Poisson epochs, the traffic of a service whose
clients submit instance lists — through both front doors, at offered loads
up to above capacity, where a batch-and-drain scheduler turns each burst
into one wide mixed batch that convoys behind its stragglers:

* **stream** — :class:`~repro_torch.serve.StreamingAnnealService`: the
  plateau chunk as the scheduling quantum, slot backfill at chunk
  boundaries, deadline shedding;
* **drain** — gather arrivals while the one-shot service is busy, then
  ``solve()`` everything queued as one batch.

Every request carries a ``target_cut`` taken from its own calibration
trace, so the work varies per request deterministically: both schedulers
see the same work, and every streamed trace must be a bit-exact prefix of
its calibration trace (checked: live-lane bit-identity, measured on the
serving path).

Metrics per (scheduler, load): p50/p99 latency (arrival → completion),
goodput (spin-cycles of on-time, target-reaching completions per second of
makespan), occupancy (live-lane chunks / slot chunks), and the shed and
late counts.  Gates: smoke — stream occupancy above drain occupancy at 2×
load, prefix determinism; full — stream goodput >= 1.5× drain goodput at
the highest load.

Writes ``BENCH_serve_stream.json``; exits 1 on a gate failure.  Runs on
the GPU (``backend='cuda'``: the kernels) unless ``--device cpu``.

    python -m repro_torch.benchmarks.serve_stream            # full sweep
    python -m repro_torch.benchmarks.serve_stream --smoke    # small
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from repro_torch.core import gset
from repro_torch.core.ssa import SSAHyperParams
from repro_torch.serve import (
    AnnealRequest,
    AnnealService,
    QueueFullError,
    StreamingAnnealService,
    StreamPolicy,
)

from .common import emit


def _pool(smoke):
    if smoke:
        return [gset.toroidal_grid(36, seed=s, name=f"t36s{s}") for s in range(4)]
    # The full mode sits where a chunk's time grows with the batch width, so
    # an idle slot costs real time and the quantum's host bookkeeping is
    # small beside it; one degree bucket, so the comparison isolates the
    # scheduling discipline (solve() would split a mixed drain batch into
    # narrower per-bucket groups while the stream pays two half-filled
    # tables).
    return [gset.toroidal_grid(800, seed=s, name=f"t800s{s}") for s in range(6)]


def _hp(smoke):
    return (SSAHyperParams(n_trials=3, m_shot=8, tau=4, i0_min=1, i0_max=8)
            if smoke else SSAHyperParams(n_trials=32, m_shot=24, tau=16))


def _service(backend, svc_kw):
    return AnnealService(backend=backend, **{"min_bucket": 16, **svc_kw})


def calibrate(problems, hp, backend, **svc_kw):
    """Solo full-budget solves: each problem's chunk trace (the ground truth
    every streamed lane must reproduce as a prefix)."""
    svc = _service(backend, svc_kw)
    entries = []
    for seed, p in enumerate(problems):
        r = svc.solve([AnnealRequest(problem=p, hp=hp, seed=seed)])[0]
        entries.append({"problem": p, "seed": seed,
                        "trace": [int(v) for v in r.chunk_best_cut]})
    return entries


def make_trace(entries, hp, n_requests, seed, interactive_frac=0.25, long_frac=0.3):
    """The request trace both schedulers replay: pool entries round-robin,
    bimodal work — most requests carry a ``target_cut`` from the early part
    of their own calibration trace (they retire in a few chunks), and
    ``long_frac`` of them run untargeted to the full budget.  Short lanes
    stuck behind long ones are the convoy a drain scheduler pays and slot
    backfill does not."""
    rng = np.random.default_rng(seed)
    budget = len(entries[0]["trace"])
    out = []
    for i in range(n_requests):
        e = entries[i % len(entries)]
        if rng.random() < long_frac:
            target, need = None, budget  # a full-budget lane
        else:
            k = int(rng.integers(1, max(2, budget // 4) + 1))
            target = e["trace"][k - 1]
            # the work: the first chunk whose best reaches the target (<= k)
            need = next(j + 1 for j, v in enumerate(e["trace"]) if v >= target)
        out.append({
            "req": AnnealRequest(problem=e["problem"], hp=hp, seed=e["seed"],
                                 target_cut=target),
            "calib_trace": e["trace"],
            "chunks_needed": need,
            "work": float(hp.total_cycles) * hp.n_trials * e["problem"].n * need / budget,
            "priority": "interactive" if rng.random() < interactive_frac else "batch",
        })
    return out


def poisson_arrivals(n, rate, seed, burst=1):
    """Compound-Poisson arrivals: bursts of ``burst`` simultaneous requests
    at Poisson epochs, aggregate rate ``rate``."""
    rng = np.random.default_rng(seed)
    epochs = np.cumsum(rng.exponential(burst / rate, size=(n + burst - 1) // burst))
    return np.repeat(epochs, burst)[:n]


def probe_service_time(entries, hp, backend, width, **svc_kw):
    """Mean wall seconds per request of a warm batch solve of ``width``."""
    svc = _service(backend, svc_kw)
    reqs = [AnnealRequest(problem=entries[i % len(entries)]["problem"], hp=hp,
                          seed=entries[i % len(entries)]["seed"])
            for i in range(width)]
    svc.solve(reqs)                      # build
    t0 = time.perf_counter()
    svc.solve(reqs)
    return (time.perf_counter() - t0) / width


def probe_stream_capacity(trace, backend, width, **svc_kw):
    """The streaming path's effective service time per request (quantum
    overheads included), on a warm second pass: (makespan / requests,
    median and largest request wall s)."""
    ss = StreamingAnnealService(service=_service(backend, svc_kw),
                                policy=StreamPolicy(slots_per_table=width))
    items = [trace[i % len(trace)] for i in range(2 * width)]
    for it in items:
        ss.submit(it["req"])
    ss.run_until_idle()                  # builds every table's programs
    t0 = time.monotonic()
    tix = [ss.submit(it["req"]) for it in items]
    ss.run_until_idle()
    makespan = time.monotonic() - t0
    walls = [t.result(timeout=0).wall_s for t in tix]
    return makespan / len(items), float(np.median(walls)), float(np.max(walls))


def run_stream(trace, arrivals, deadline_s, backend, width, *, result_timeout_s=600.0,
               **svc_kw):
    """Replay the arrival trace through the streaming front door, on its
    background thread; every ticket is waited on for at most
    ``result_timeout_s`` (the thread stops on a fault)."""
    ss = StreamingAnnealService(service=_service(backend, svc_kw),
                                policy=StreamPolicy(slots_per_table=width))
    # Warm every table's programs: a long-lived server runs warm.
    warm = [ss.submit(trace[i % len(trace)]["req"]) for i in range(min(2 * width, len(trace)))]
    ss.run_until_idle()
    for w in warm:
        w.result(timeout=0)
    occ0 = (ss.stats["stream_live_lane_chunks"], ss.stats["stream_slot_chunks"])

    ss.start(poll_s=0.001)
    records = []
    t0 = time.monotonic()
    try:
        for item, t_arr in zip(trace, arrivals):
            lag = t0 + t_arr - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            req = dataclasses.replace(item["req"], deadline_s=deadline_s)
            try:
                ticket = ss.submit(req, priority=item["priority"])
            except QueueFullError:
                records.append({"item": item, "arrival": t_arr, "rejected": True})
                continue
            records.append({"item": item, "arrival": t_arr, "ticket": ticket})
        for r in records:
            if "ticket" in r:
                resp = r["ticket"].result(timeout=result_timeout_s)
                r["resp"] = resp
                # latency on the service's own clock (submit → done)
                if resp.wall_s is not None:
                    r["latency"] = resp.wall_s
                    r["end"] = r["arrival"] + resp.wall_s
    finally:
        ss.stop()
    live = ss.stats["stream_live_lane_chunks"] - occ0[0]
    slot = ss.stats["stream_slot_chunks"] - occ0[1]
    return records, {"occupancy": live / max(1, slot),
                     **{k: int(v) for k, v in ss.stream_stats().items()
                        if k.startswith("stream_")}}


def run_drain(trace, arrivals, backend, width, **svc_kw):
    """Drain-the-bucket baseline: batch everything queued, solve, repeat.
    Deadlines are accounted outside (completion − arrival): the baseline
    only pays the convoy — every batch runs until its slowest lane ends."""
    svc = _service(backend, svc_kw)
    fams = {}                            # one warm set per degree bucket
    for t in trace:
        fams.setdefault(t["req"].problem.name[0], []).append(t)
    for w in (1, 2, 4, 8):               # warm the power-of-two widths...
        if w <= width:
            for fam in fams.values():    # ...of every family of the pool
                svc.solve([fam[i % len(fam)]["req"] for i in range(w)])
    occ0 = (svc.stats["live_lane_chunks"], svc.stats["slot_chunks"])

    records = [{"item": it, "arrival": t_arr} for it, t_arr in zip(trace, arrivals)]
    t0 = time.monotonic()
    i = 0
    while i < len(records):
        now = time.monotonic() - t0
        nxt = records[i]["arrival"]
        if now < nxt:
            time.sleep(nxt - now)
        now = time.monotonic() - t0
        j = i
        while j < len(records) and records[j]["arrival"] <= now:
            j += 1
        batch = records[i:j]
        # the stream's table width: the comparison isolates scheduling
        for k in range(0, len(batch), width):
            part = batch[k:k + width]
            resps = svc.solve([b["item"]["req"] for b in part])
            done = time.monotonic() - t0
            for b, resp in zip(part, resps):
                b["resp"] = resp
                b["latency"] = done - b["arrival"]
                b["end"] = done
        i = j
    live = svc.stats["live_lane_chunks"] - occ0[0]
    slot = svc.stats["slot_chunks"] - occ0[1]
    return records, {"occupancy": live / max(1, slot)}


def score(records, deadline_s):
    """Latency percentiles and the goodput of one replay."""
    lat, good_work, n_good, n_late, n_dropped = [], 0.0, 0, 0, 0
    makespan = 0.0
    for r in records:
        if r.get("rejected") or r.get("resp") is None:
            n_dropped += 1
            continue
        resp = r["resp"]
        if resp.status in ("shed", "failed") or resp.result is None or "latency" not in r:
            n_dropped += 1
            continue
        latency = r["latency"]
        lat.append(latency)
        makespan = max(makespan, r["end"])
        tgt = r["item"]["req"].target_cut
        hit = tgt is None or int(np.max(np.asarray(resp.result.best_cut))) >= tgt
        if hit and latency <= deadline_s:
            good_work += r["item"]["work"]
            n_good += 1
        else:
            n_late += 1
    return {
        "completed": len(lat),
        "on_time": n_good,
        "late": n_late,
        "dropped": n_dropped,
        "p50_s": float(np.percentile(lat, 50)) if lat else None,
        "p99_s": float(np.percentile(lat, 99)) if lat else None,
        "makespan_s": makespan,
        "goodput_cycles_per_s": good_work / makespan if makespan else 0.0,
    }


def check_prefix_determinism(records):
    """The number of streamed lanes whose trace is not a prefix of their
    calibration trace (live-lane bit-identity on the serving path)."""
    bad = 0
    for r in records:
        resp = r.get("resp")
        if resp is None or resp.result is None:
            continue
        got = [int(v) for v in resp.chunk_best_cut]
        if got != r["item"]["calib_trace"][:len(got)]:
            bad += 1
    return bad


def run(smoke=False, json_path="BENCH_serve_stream.json", backend="cuda", seed=0,
        device=None):
    problems, hp = _pool(smoke), _hp(smoke)
    width = 2 if smoke else 8
    n_requests = 10 if smoke else 48
    loads = (2.0,) if smoke else (0.5, 2.0)
    kw = {"device": device}

    entries = calibrate(problems, hp, backend, **kw)
    trace = make_trace(entries, hp, n_requests, seed)
    s_batch = probe_service_time(entries, hp, backend, width, **kw)
    s_stream, lane_p50, lane_max = probe_stream_capacity(trace, backend, width, **kw)
    # deadline: even a full-budget lane fits with queueing headroom
    deadline_s = max(2.0 * lane_max, 0.25)

    report = {"smoke": smoke, "backend": backend, "device": str(device or "cuda"),
              "width": width, "n_requests": n_requests, "batched_service_time_s": s_batch,
              "stream_service_time_s": s_stream, "lane_p50_s": lane_p50,
              "lane_max_s": lane_max, "deadline_s": deadline_s, "loads": {}}
    failures = []

    for load in loads:
        # offered load relative to the measured streaming capacity
        rate = load / max(s_stream, 1e-6)
        arrivals = poisson_arrivals(n_requests, rate, seed, burst=width)
        srec, sstats = run_stream(trace, arrivals, deadline_s, backend, width, **kw)
        drec, dstats = run_drain(trace, arrivals, backend, width, **kw)
        s_score, d_score = score(srec, deadline_s), score(drec, deadline_s)
        bad_prefix = check_prefix_determinism(srec)
        if d_score["goodput_cycles_per_s"] > 0:
            ratio = s_score["goodput_cycles_per_s"] / d_score["goodput_cycles_per_s"]
        else:                            # drain served nothing on time
            ratio = float("inf") if s_score["goodput_cycles_per_s"] else 1.0
        ratio = min(ratio, 1e6)
        report["loads"][str(load)] = {
            "offered_rate_rps": rate,
            "stream": {**s_score, **sstats},
            "drain": {**d_score, **dstats},
            "goodput_ratio": ratio,
            "prefix_mismatches": bad_prefix,
        }
        emit(f"serve_stream/load{load}/stream", (s_score["p50_s"] or 0) * 1e6,
             s_score["goodput_cycles_per_s"])
        emit(f"serve_stream/load{load}/drain", (d_score["p50_s"] or 0) * 1e6,
             d_score["goodput_cycles_per_s"])
        emit(f"serve_stream/load{load}/goodput_ratio", 0.0, f"{ratio:.2f}")
        if bad_prefix:
            failures.append(f"load {load}: {bad_prefix} streamed traces diverged from their "
                            "calibration traces (bit-identity broken)")

    high = report["loads"][str(loads[-1])]
    if smoke:
        # The structural win must show even on a tiny run: backfill keeps
        # slots live while drain convoys behind stragglers.
        if high["stream"]["occupancy"] <= high["drain"]["occupancy"]:
            failures.append(f"smoke: stream occupancy {high['stream']['occupancy']:.3f} "
                            f"<= drain occupancy {high['drain']['occupancy']:.3f}")
    elif high["goodput_ratio"] < 1.5:
        failures.append(f"high load: goodput ratio {high['goodput_ratio']:.2f} < 1.5x")

    report["failures"] = failures
    report["ok"] = not failures
    if json_path:
        with open(json_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {json_path}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small pool, one load point, occupancy gate")
    ap.add_argument("--backend", default="cuda", choices=("sparse", "dense", "cuda"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--json", default="BENCH_serve_stream.json")
    args = ap.parse_args(argv)
    rep = run(smoke=args.smoke, json_path=args.json, backend=args.backend, device=args.device)
    if not rep["ok"]:
        for f in rep["failures"]:
            print(f"FAIL: {f}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
