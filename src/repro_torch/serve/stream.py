"""Continuous-batching streaming front door of the annealing service (port
of ``repro.serve.stream``).

``AnnealService.solve`` is a one-shot batch call: a whole shape bucket
drains at the pace of its slowest lane.  Production traffic arrives as a
stream, and the service's substrate — plateau chunks as the unit of
execution, padding-invariant per-problem lanes, problem arrays as call-time
arguments of cached programs — is what continuous batching needs.
:class:`StreamingAnnealService` builds it:

* **Slot tables** — one resident batched engine state per ``(bucket,
  degree, trials, schedule, chunk, options)`` *stream key*, of a fixed
  width (``slots_per_table``).  The programs come from the owning
  :class:`~repro_torch.serve.anneal_service.AnnealService`'s bounded
  program cache, shared with the one-shot path (its key leaves out
  ``m_shot``).  On ``backend='cuda'`` every quantum of a table is one
  launch of K1 or K4 per plateau, or of K2 per chain, across all its slots.
* **The plateau chunk is the scheduling quantum** — each ``pump()`` runs
  one chunk of one table, then walks its chunk boundary: lanes that
  reached their ``target_cut``, used their chunk budget or passed their
  deadline retire, and their slots are backfilled from the queue
  (:func:`repro_torch.core.engine.splice_slot`): no lane waits for the
  bucket to drain.  A free slot keeps running its last occupant's (or the
  table's first model's) lanes; its readings never reach a ticket.
* **Bit-identity** — a backfilled lane is seeded by the same
  ``padded_noise_init`` stream a one-shot solo solve uses, and lanes never
  interact, so a request served through the stream returns the same
  ``best_cut`` and spins as ``AnnealService.solve`` of it.
* **Admission and scheduling** — ``submit()`` validates as ``solve()``
  does (:class:`AdmissionError`), resolves ``hp='auto'`` so the scheduler
  has every request's cost estimate, and bounds the queue
  (:class:`QueueFullError`).  The order is priority class ('interactive'
  before 'batch') with aging promotion (no starvation), then earliest
  deadline first, then FIFO.  Queued requests whose deadline has passed
  are shed (``status='shed'``) instead of wasting device work.
* **Per-slot resilience** — deadlines and the non-finite quarantine act on
  single slots.  Per-slot checkpoints use the one-shot fingerprint of a
  single-request group, so a killed stream resumes each in-flight lane
  from its own last chunk boundary, and a slot checkpoint is
  interchangeable with the same request's one-shot solo checkpoint.  An
  injected compile or out-of-memory fault rebuilds the table one step down
  the fallback chain and carries its engine state across: every batched
  backend keeps the same state layout (types, dtypes, shapes), and the
  trajectory depends only on the noise, so the downgrade is bit-exact.  A
  real kernel build, launch or memory fault of the cuda backend raises out
  of ``pump()`` (:func:`~repro_torch.serve.resilience.classify_fault`).

Problem encodings (:class:`~repro_torch.problems.ProblemEncoding`) are
served as their Ising models, and a finished response carries the decoded
``solution``, ``objective`` and ``feasible``, as the one-shot service's.

Under ``partition='spin'`` a table's lanes are spin-sharded over the
service's mesh (every rank submitting the same requests in the same order
and pumping alike), its per-slot checkpoints hold whole arrays written by
rank 0, and under a mesh of several ranks every time-based decision —
shedding, aging, deadlines — reads the slowest rank's clock, so the ranks
seat and retire alike.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..checkpoint.ckpt import CheckpointManager
from ..core.autotune import autotune_hyperparams, resolve_hyperparams
from ..core.engine import (
    bucket_n,
    extract_slot,
    finalize_cut,
    next_pow2,
    normalize_problem,
    pad_degree,
    resolve_backend,
    splice_slot,
)
from ..core.rng import xorshift_lanes_ok
from ..core.ssa import AnnealResult, SSAHyperParams
from ..problems import ProblemEncoding
from ..sharding import max_over_ranks, mesh_fingerprint
from .anneal_service import (
    AnnealProgress,
    AnnealRequest,
    AnnealResponse,
    AnnealService,
    _largest_divisor_leq,
    SPLIT_CHECKPOINTS,
    _opts_key,
    agreed_latest_step,
    purge_checkpoints,
    save_checkpoint,
)
from .registry import family_for
from .resilience import (
    STATUS_DEADLINE,
    STATUS_FAILED,
    STATUS_FALLBACK,
    STATUS_OK,
    STATUS_QUARANTINED,
    STATUS_SHED,
    AdmissionError,
    QueueFullError,
    ServiceEvent,
    classify_fault,
    fallback_step,
    filter_backend_opts,
    group_fingerprint,
)

__all__ = ["StreamPolicy", "StreamTicket", "StreamingAnnealService"]

PRIORITIES = ("interactive", "batch")  # rank order, best first


@dataclasses.dataclass(frozen=True)
class StreamPolicy:
    """Scheduler knobs of :class:`StreamingAnnealService`.

    slots_per_table:  batch width of every slot table (a power of two, so
                      stream tables share programs with one-shot groups of
                      the same width).
    max_tables:       resident slot tables (distinct stream keys) at once;
                      bounds live engine state, not correctness: other keys
                      wait in the queue.
    max_queue:        admission bound on queued requests (QueueFullError).
    max_queue_cost:   optional admission bound on the queue's summed
                      estimated spin-cycles.
    aging_s:          a 'batch' request older than this ranks as
                      'interactive': the starvation bound.
    shed_expired:     drop queued requests whose deadline has passed
                      (status='shed') instead of running unmeetable work.
    """

    slots_per_table: int = 4
    max_tables: int = 4
    max_queue: int = 4096
    max_queue_cost: Optional[float] = None
    aging_s: float = 30.0
    shed_expired: bool = True

    def __post_init__(self):
        if self.slots_per_table != next_pow2(self.slots_per_table):
            raise ValueError(f"slots_per_table must be a power of two, got "
                             f"{self.slots_per_table}")
        if self.max_tables < 1 or self.max_queue < 1:
            raise ValueError("max_tables and max_queue must be >= 1")


class StreamTicket:
    """Handle of one submitted request: status, timing and the response.

    ``status``: 'queued' → 'running' → 'done' (a shed request goes straight
    to 'done' with ``response.status == 'shed'``).  ``result()`` blocks
    until the response is there.
    """

    def __init__(self, seq: int, request: AnnealRequest, priority: str, submit_t: float,
                 cost: float, autotune=None):
        self.seq = seq
        self.request = request          # hp resolved (never 'auto')
        self.priority = priority
        self.submit_t = submit_t
        self.cost = cost                # estimated spin-cycles (scheduling)
        self.autotune = autotune
        self.status = "queued"
        self.t_seated: Optional[float] = None
        self.retries = 0
        self.events: List[ServiceEvent] = []
        self.response: Optional[AnnealResponse] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> AnnealResponse:
        if not self._done.wait(timeout):
            raise TimeoutError(f"ticket {self.seq} not done")
        return self.response

    def __repr__(self):
        return (f"StreamTicket(seq={self.seq}, priority={self.priority!r}, "
                f"status={self.status!r})")


class _Slot:
    """One seated request of a table."""

    def __init__(self, ticket: StreamTicket, model, maxcut, budget: int):
        self.ticket = ticket
        self.model = model
        self.maxcut = maxcut
        self.budget = budget            # chunk budget (m_shot // table.chunk)
        self.chunks_done = 0
        self.trace: List[int] = []
        self.ckpt: Optional[CheckpointManager] = None
        self.ckpt_dir: Optional[str] = None


class _SlotTable:
    """One resident batch: stacked problems, engine state and slots."""

    def __init__(self, key, nb, d_bucket, chunk, backend, opts, part, storage, schedule_kind,
                 hp0, kind="ssa"):
        self.key = key
        self.nb = nb
        self.d_bucket = d_bucket
        self.chunk = chunk              # plateau iterations per quantum
        self.backend = backend          # effective (may walk the fallback chain)
        self.opts = dict(opts)
        self.part = part
        self.kind = kind                # family name: 'ssa' | 'ssqa'
        self.storage = storage
        self.schedule_kind = schedule_kind
        self.hp0 = hp0                  # exemplar: n_trials, n_rnd, schedule
        self.model0 = None              # the model of never-used slots
        self.bk = None
        self.chunk_fn = None
        self.bk1 = None                 # its B = 1 twin: lane init of a seat
        self.init1 = None
        self.plateaus = None
        self.stored_per_iter = 0
        self.stacked = None
        self.state = None
        self.slots: List[Optional[_Slot]] = []
        self.quanta = 0
        self.degraded = False           # walked the fallback chain
        self.events: List[ServiceEvent] = []  # copied to tickets at seat

    @property
    def n_live(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None


class StreamingAnnealService:
    """Always-on streaming wrapper over :class:`AnnealService`.

    Wrap a service (``StreamingAnnealService(service=svc)``: shares its
    program cache, resilience policy, fault hooks and device) or pass
    :class:`AnnealService` keywords.  Drive it synchronously (``submit()``
    and ``run_until_idle()`` / ``pump()``) or as a background loop
    (``start()`` / ``stop()``).  Only plateau-family requests (SSA and
    SSQA: the Trotter replicas live on the trial axis, which splice and
    extract carry untouched) are admitted; SA and PT-SSA requests belong on
    the one-shot path and are rejected with :class:`AdmissionError`.

    The background loop ends on an exception, and a ticket waited on with
    ``result(timeout=None)`` then never completes: drive the stream from
    the main thread with ``run_until_idle()``, or wait with a finite
    timeout, where a fault must fail the caller.
    """

    def __init__(self, service: Optional[AnnealService] = None, *,
                 policy: Optional[StreamPolicy] = None, **service_kwargs):
        if service is not None and service_kwargs:
            raise ValueError("pass either a service or its kwargs, not both")
        self.service = service or AnnealService(**service_kwargs)
        self.policy = policy or StreamPolicy()
        self.stats = self.service.stats  # one observability surface
        self._lock = threading.RLock()
        self._queue: List[StreamTicket] = []
        self._tables: Dict[tuple, _SlotTable] = {}
        self._seq = 0
        self._rr = 0                    # round-robin cursor over tables
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    # Admission (the front door)
    # ------------------------------------------------------------------
    def submit(self, request: AnnealRequest, *, priority: str = "batch") -> StreamTicket:
        """Admit one request into the stream; returns its ticket.

        Validation and ``hp='auto'`` resolution happen here, so a rejected
        request costs no device work and the scheduler knows every queued
        request's cost; :class:`QueueFullError` is the backpressure signal.
        ``request.deadline_s`` runs from submission: queueing counts.
        """
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}; use {PRIORITIES}")
        svc = self.service
        try:
            maxcut, model = normalize_problem(request.problem)
        except TypeError as e:
            raise AdmissionError(str(e)) from e
        with self._lock:
            seq = self._seq
            self._seq += 1
        if svc.policy.validate_admission:
            svc._admit(seq, request, model)
        report = None
        if isinstance(request.hp, str):
            hp, report = resolve_hyperparams(request.hp, model, base=request.auto_base,
                                             seed=svc.autotune_seed, algo=request.algo)
            request = dataclasses.replace(request, hp=hp)
            self.stats["autotuned"] += 1
        fam = family_for(request.hp, algo=request.algo)
        if fam.solver != "_solve_ssa_group":
            raise AdmissionError(
                "the streaming service serves plateau-family requests only (ssa/ssqa); "
                f"got {type(request.hp).__name__} (use AnnealService.solve)")
        if fam.validate is not None:
            fam.validate(svc, seq, request, request.hp)
        cost = float(request.hp.total_cycles) * request.hp.n_trials * model.n
        ticket = StreamTicket(seq, request, priority, time.monotonic(), cost, autotune=report)
        ticket._model, ticket._maxcut = model, maxcut
        with self._lock:
            if len(self._queue) >= self.policy.max_queue:
                self.stats["stream_rejected_queue_full"] += 1
                raise QueueFullError(f"queue at capacity ({self.policy.max_queue})")
            if self.policy.max_queue_cost is not None:
                pending = sum(t.cost for t in self._queue)
                if pending + cost > self.policy.max_queue_cost:
                    self.stats["stream_rejected_queue_full"] += 1
                    raise QueueFullError(
                        f"queue cost bound {self.policy.max_queue_cost:g} would be exceeded")
            self._queue.append(ticket)
            self.stats["stream_submitted"] += 1
        return ticket

    # ------------------------------------------------------------------
    # The scheduler: one plateau chunk per pump() call
    # ------------------------------------------------------------------
    def pump(self, progress: Optional[Callable[[AnnealProgress], None]] = None) -> bool:
        """One scheduling quantum: seat queued work, run one plateau chunk
        of one table (round-robin), retire and backfill at its boundary.

        Returns False when the stream is idle (empty queue, no live slot).
        Call from one thread (or use ``start()``).
        """
        with self._lock:
            self._shed_expired()
            self._seat_queued()
            table = self._pick_table()
            if table is None:
                return False
        self._run_quantum(table, progress)
        return True

    def run_until_idle(self, progress: Optional[Callable[[AnnealProgress], None]] = None
                       ) -> None:
        """Drive ``pump()`` until every submitted request has completed."""
        while self.pump(progress):
            pass

    def start(self, poll_s: float = 0.002) -> None:
        """Start the background scheduler thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._serve_loop, args=(poll_s,),
                                            name="anneal-stream", daemon=True)
            self._thread.start()

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def _serve_loop(self, poll_s: float):
        while not self._stop.is_set():
            if not self.pump():
                self._stop.wait(poll_s)

    def stream_stats(self) -> dict:
        """Scheduler observability: queue depth, occupancy, counters."""
        with self._lock:
            live = sum(t.n_live for t in self._tables.values())
            width = sum(len(t.slots) for t in self._tables.values())
            slot_chunks = self.stats["stream_slot_chunks"]
            live_chunks = self.stats["stream_live_lane_chunks"]
            return {
                "queued": len(self._queue),
                "tables": len(self._tables),
                "live_slots": live,
                "table_width": width,
                "occupancy": (live_chunks / slot_chunks) if slot_chunks else 0.0,
                **{k: v for k, v in self.stats.items() if k.startswith("stream_")},
            }

    # ------------------------------------------------------------------
    # Queue order: priority class (with aging), then EDF, then FIFO
    # ------------------------------------------------------------------
    def _ages(self, tickets) -> List[float]:
        """Seconds since each ticket's submission — under a mesh of several
        ranks the largest over the ranks (one all-reduce), so that every
        rank takes the same time-based decision."""
        now = time.monotonic()
        return max_over_ranks(self.service.mesh, [now - t.submit_t for t in tickets])

    def _rank(self, ticket: StreamTicket, age: float):
        rank = PRIORITIES.index(ticket.priority)
        if rank and age >= self.policy.aging_s:
            rank = 0  # aged into the top class: the starvation bound
        dl = ticket.request.deadline_s
        time_left = dl - age if dl is not None else np.inf  # earliest deadline first
        return (rank, time_left, ticket.seq)

    def _shed_expired(self):
        if not self.policy.shed_expired:
            return
        keep = []
        for t, age in zip(self._queue, self._ages(self._queue)):
            dl = t.request.deadline_s
            if dl is not None and age >= dl:
                self._complete_unrun(t, STATUS_SHED, "shed")
            else:
                keep.append(t)
        self._queue = keep

    def _complete_unrun(self, ticket: StreamTicket, status: str, event: str):
        ticket.events.append(ServiceEvent(event, {"request": ticket.seq},
                                          time.monotonic() - ticket.submit_t))
        ticket.response = AnnealResponse(
            request=ticket.request, result=None, wall_s=time.monotonic() - ticket.submit_t,
            bucket=bucket_n(ticket._model.n, self.service.min_bucket), batch=0, chunks_run=0,
            chunks_total=0, chunk_best_cut=np.zeros(0, np.int64), autotune=ticket.autotune,
            status=status, events=list(ticket.events))
        ticket.status = "done"
        self.stats[f"stream_{event}"] += 1
        ticket._done.set()

    # ------------------------------------------------------------------
    # Seating: stream keys, table creation, slot backfill
    # ------------------------------------------------------------------
    def _stream_key(self, ticket: StreamTicket):
        """The slot-table identity of one request (everything that shapes
        the program): requests share a table iff they can share its chunk
        program and its stacked problem arrays.  SSQA requests key and run
        under their family name, the ring depth in the options, as in the
        one-shot group solver; a per-request :class:`SolverConfig`
        re-derives backend and options and joins the key by its
        signature."""
        svc = self.service
        req = ticket.request
        hp: SSAHyperParams = req.hp
        kind = family_for(hp, algo=req.algo).name
        model = ticket._model
        nb = bucket_n(model.n, svc.min_bucket)
        d_bucket = next_pow2(max(1, model.max_degree))
        chunk = _largest_divisor_leq(hp.m_shot, svc.chunk_shots)
        cfg = req.config
        if cfg is not None:
            backend = cfg.backend
            opts = cfg.engine_opts()
            opts.pop("storage_layout", None)
        else:
            backend = svc.backend
            opts = dict(svc.backend_opts)
        part = svc.partition_for(kind, nb)
        if backend == "auto":
            backend = resolve_backend(backend, nb)
            opts = filter_backend_opts(backend, opts, partition=part)
        opts = svc._resolve_field_opts(backend, opts, [(ticket.seq, req, None, model)])
        nr = int(getattr(hp, "n_replicas", 0) or 0)
        if nr:
            opts["n_replicas"] = nr
            if backend == "cuda":
                opts.setdefault("noise_mode", "streamed")
        sig = hp.schedule(req.schedule_kind).signature()
        return ("stream-" + kind, nb, d_bucket, hp.n_trials, hp.n_rnd, req.storage, sig, chunk,
                backend, _opts_key(opts), part,
                mesh_fingerprint(svc.mesh) if part == "spin" else (),
                cfg.signature() if cfg is not None else None), \
            (nb, d_bucket, chunk, backend, opts, part, kind)

    def _seat_queued(self):
        """Fill free slots (opening new tables) from the queue in rank
        order, then drop the idle tables that match nothing still queued.
        Runs under the lock."""
        if not self._queue:
            return
        ages = dict(zip((t.seq for t in self._queue), self._ages(self._queue)))
        self._queue.sort(key=lambda t: self._rank(t, ages[t.seq]))
        leftover = []
        for ticket in self._queue:
            key, params = self._stream_key(ticket)
            table = self._tables.get(key)
            if table is None:
                if len(self._tables) >= self.policy.max_tables:
                    leftover.append(ticket)
                    continue
                table = self._create_table(key, params, ticket)
            slot = table.free_slot()
            if slot is None:
                leftover.append(ticket)
                continue
            self._seat(table, slot, ticket)
        self._queue = leftover
        self._drop_idle_tables()

    def _drop_idle_tables(self):
        """Drop empty tables whose key matches nothing queued: frees table
        budget (and engine state) for other stream keys."""
        dead = [k for k, t in self._tables.items() if t.n_live == 0]
        if dead:
            queued = {self._stream_key(t)[0] for t in self._queue}
            for k in dead:
                if k not in queued:
                    del self._tables[k]

    def _programs_for(self, table: _SlotTable):
        """(Re)bind the table's programs and backends from the service's
        program cache (at creation and after a fallback downgrade)."""
        svc = self.service
        fire = svc.faults.fire if svc.faults is not None else None
        bk, _, chunk_fn, plateaus = svc._ssa_programs(
            nb=table.nb, b_bucket=self.policy.slots_per_table, hp=table.hp0,
            storage=table.storage, schedule_kind=table.schedule_kind, backend=table.backend,
            opts=table.opts, chunk=table.chunk, fire=fire, kind=table.kind)
        bk1, init1, _, _ = svc._ssa_programs(
            nb=table.nb, b_bucket=1, hp=table.hp0, storage=table.storage,
            schedule_kind=table.schedule_kind, backend=table.backend, opts=table.opts,
            chunk=table.chunk, kind=table.kind)
        table.bk, table.chunk_fn, table.plateaus = bk, chunk_fn, plateaus
        table.bk1, table.init1 = bk1, init1
        table.stored_per_iter = sum(p.length for p in plateaus if p.eligible)

    def _create_table(self, key, params, ticket: StreamTicket) -> _SlotTable:
        nb, d_bucket, chunk, backend, opts, part, kind = params
        svc = self.service
        req = ticket.request
        S = self.policy.slots_per_table
        model0 = pad_degree(ticket._model, d_bucket)
        carried: List[ServiceEvent] = []
        while True:
            # An injected compile or out-of-memory fault at build walks the
            # fallback chain before any slot is seated (as the one-shot path
            # does); the table keeps the original stream key — the key
            # routes requests, the table records the effective backend.
            table = _SlotTable(key, nb, d_bucket, chunk, backend, opts, part, req.storage,
                               req.schedule_kind, req.hp, kind=kind)
            table.model0 = model0
            table.events = list(carried)
            table.degraded = bool(carried)
            try:
                self._programs_for(table)
                if svc.faults is not None:
                    svc.faults.fire("oom", backend=backend, kind=kind, bucket=nb, batch=S,
                                    j_mode=getattr(table.bk, "j_mode", None))
                table.stacked = table.bk.stack([model0] * S)
                ns0 = table.bk.init_noise([req.seed] * S, [ticket._model.n] * S)
                table.state = table.bk.init_state(table.stacked, ns0)
            except Exception as exc:  # noqa: BLE001 — classified below
                fault = classify_fault(exc, backend)
                nxt = (fallback_step(backend, opts, fault, nb)
                       if fault is not None and svc.policy.fallback else None)
                if nxt is None:
                    raise
                self.stats[f"fallback_{fault}"] += 1
                carried.append(ServiceEvent(
                    "fallback", {"from": backend, "to": nxt[0], "fault": fault,
                                 "error": f"{type(exc).__name__}: {exc}"[:200]},
                    time.monotonic()))
                backend, opts = nxt
                continue
            table.slots = [None] * S
            self._tables[key] = table
            self.stats["stream_tables_created"] += 1
            return table

    def _lane_fingerprint(self, table: _SlotTable, ticket: StreamTicket) -> str:
        """Per-slot checkpoint identity: the request's one-shot solo-group
        fingerprint (same kind, bucket, backend and chunk, a one-item
        group), so slot and solo-group checkpoints are interchangeable."""
        svc = self.service
        return group_fingerprint(
            table.kind, table.nb, table.backend, svc.storage_layout, svc.noise, table.chunk,
            [(0, ticket.request, ticket._maxcut, ticket._model)], partition=table.part,
            mesh_fp=mesh_fingerprint(svc.mesh) if table.part == "spin" else ())

    def _seat(self, table: _SlotTable, slot: int, ticket: StreamTicket):
        """Splice one request into a table slot: a fresh lane (the
        ``padded_noise_init`` stream of a solo solve) or a lane resumed from
        its per-slot checkpoint.  The whole table is copied once per seat
        (``splice_slot``) and the request's problem arrays are built on the
        host (``bk1.stack``)."""
        svc = self.service
        req = ticket.request
        hp: SSAHyperParams = req.hp
        model = pad_degree(ticket._model, table.d_bucket)
        budget = hp.m_shot // table.chunk
        s = _Slot(ticket, model, ticket._maxcut, budget)

        stacked1 = table.bk1.stack([model])
        ns1 = table.bk1.init_noise([req.seed], [ticket._model.n])
        lane = table.init1(stacked1, ns1)

        if svc.policy.checkpoint_dir:
            s.ckpt_dir = os.path.join(svc.policy.checkpoint_dir,
                                      self._lane_fingerprint(table, ticket))
            s.ckpt = CheckpointManager(
                s.ckpt_dir, save_interval=max(1, int(svc.policy.checkpoint_interval)),
                keep=svc.policy.keep_checkpoints, async_save=False)
            step, split = agreed_latest_step(s.ckpt_dir, table.bk1)
            if split:
                ticket.events.append(ServiceEvent(
                    "checkpoint_rejected", {"request": ticket.seq, "dir": s.ckpt_dir,
                                            "reason": SPLIT_CHECKPOINTS},
                    time.monotonic() - ticket.submit_t))
            elif step is not None:
                restored, meta = s.ckpt.restore_latest(table.bk1.checkpoint_state(lane))
                traces = meta.get("traces")
                ok = isinstance(traces, list) and len(traces) == 1
                if ok and svc.noise == "xorshift":
                    ok = xorshift_lanes_ok(restored.noise_state, axis=1)
                if table.bk1.rank_span(int(ok))[0] == 1:
                    lane = table.bk1.restore_state(restored)
                    s.chunks_done = int(meta["step"])
                    s.trace = [int(v) for v in traces[0]]
                    ticket.events.append(ServiceEvent(
                        "resume", {"request": ticket.seq, "chunk": s.chunks_done,
                                   "dir": s.ckpt_dir},
                        time.monotonic() - ticket.submit_t))
                    self.stats["stream_resumes"] += 1
                else:
                    ticket.events.append(ServiceEvent(
                        "checkpoint_rejected", {"request": ticket.seq, "dir": s.ckpt_dir},
                        time.monotonic() - ticket.submit_t))

        ticket.status = "running"
        ticket.t_seated = time.monotonic()
        ticket.events.extend(table.events)  # e.g. build-time fallbacks
        ticket.events.append(ServiceEvent(
            "seat", {"request": ticket.seq, "slot": slot, "table": repr(table.key[:3])},
            ticket.t_seated - ticket.submit_t))
        self.stats["stream_seated"] += 1

        if s.chunks_done >= s.budget:
            # Resumed at (or past) completion: finish without device work.
            bh1, bm1 = table.bk1.finalize(lane)
            self._finish(table, s, bh1.cpu().numpy()[0], bm1.cpu().numpy()[0], STATUS_OK,
                         "budget")
            return

        table.stacked = splice_slot(table.stacked, slot, stacked1)
        table.state = splice_slot(table.state, slot, lane)
        table.slots[slot] = s
        self.stats["stream_backfills"] += 1

    # ------------------------------------------------------------------
    # The quantum: one chunk and its boundary
    # ------------------------------------------------------------------
    def _pick_table(self) -> Optional[_SlotTable]:
        tables = [t for t in self._tables.values() if t.n_live > 0]
        if not tables:
            return None
        self._rr += 1
        return tables[self._rr % len(tables)]

    def _run_quantum(self, table: _SlotTable, progress):
        svc = self.service
        try:
            new_state = table.chunk_fn(table.stacked, table.state)
            best_H = new_state.best_H.cpu().numpy()  # the report: a device sync
        except Exception as exc:  # noqa: BLE001 — classified in _table_fault
            self._table_fault(table, exc)
            return
        table.state = new_state
        table.quanta += 1
        self.stats["stream_quanta"] += 1
        self.stats["stream_slot_chunks"] += len(table.slots)
        self.stats["stream_live_lane_chunks"] += table.n_live

        # The 'nan' hook corrupts the detector's float view (as on the
        # one-shot path); the detection is the production check.
        readings = best_H.astype(np.float64)
        spec = (svc.faults.fire("nan", kind=table.kind, chunk=table.quanta - 1)
                if svc.faults is not None else None)
        if spec is not None:
            for sl in (spec.slots or range(len(table.slots))):
                if sl < len(table.slots):
                    readings[sl] = np.nan

        retired = []  # (slot, status, reason)
        bests = {}
        seated = [s.ticket for s in table.slots if s is not None]
        ages = (dict(zip((t.seq for t in seated), self._ages(seated)))
                if any(t.request.deadline_s is not None for t in seated) else {})
        for i, s in enumerate(table.slots):
            if s is None:
                continue
            s.chunks_done += 1
            if not np.all(np.isfinite(readings[i])):
                self.stats["nonfinite_detected"] += 1
                retired.append((i, STATUS_QUARANTINED, "quarantine"))
                continue
            best = int(np.max(np.asarray(finalize_cut(best_H[i], s.maxcut))))
            s.trace.append(best)
            bests[i] = best
            req = s.ticket.request
            if req.target_cut is not None and best >= req.target_cut:
                retired.append((i, STATUS_OK, "target"))
            elif s.chunks_done >= s.budget:
                retired.append((i, STATUS_OK, "budget"))
            elif req.deadline_s is not None and ages[s.ticket.seq] >= req.deadline_s:
                retired.append((i, STATUS_DEADLINE, "deadline"))

        if progress is not None:
            live = [(i, s) for i, s in enumerate(table.slots) if s is not None and i in bests]
            progress(AnnealProgress(
                kind=table.kind, bucket=table.nb, chunk=table.quanta - 1, chunks_total=0,
                request_indices=tuple(s.ticket.seq for _, s in live),
                best_cut=tuple(bests[i] for i, _ in live)))

        # Checkpoint the surviving lanes at the boundary, then fire the kill
        # hook (the one-shot chunk loop's crash window).
        retiring = {i for i, _, _ in retired}
        if svc.policy.checkpoint_dir:
            for i, s in enumerate(table.slots):
                if s is None or i in retiring or s.ckpt is None:
                    continue
                save_checkpoint(s.ckpt, table.bk1, s.chunks_done, extract_slot(table.state, i),
                                {"traces": [s.trace]})
        if svc.faults is not None:
            svc.faults.fire("kill", kind=table.kind, chunk=table.quanta - 1)

        if retired:
            bh_dev, bm_dev = table.bk.finalize(table.state)
            bh_all, bm_all = bh_dev.cpu().numpy(), bm_dev.cpu().numpy()
            for i, status, reason in retired:
                s = table.slots[i]
                table.slots[i] = None
                if reason == "quarantine":
                    self._requeue_quarantined(s)
                else:
                    self._finish(table, s, bh_all[i], bm_all[i], status, reason)

    def _table_fault(self, table: _SlotTable, exc: BaseException):
        """Walk the fallback chain in place, carrying the engine state.

        The stacked problem arrays are rebuilt from the slots' models on the
        downgraded backend.  The state is not converted: every batched
        backend carries the same state tree in a storage layout (the same
        leaf types, dtypes and shapes; tested), and the trajectory depends
        only on the noise, so every seated lane goes on bit-identically.  A
        fault that :func:`classify_fault` does not class — among them a
        real kernel build, launch or memory fault of the cuda backend —
        raises, as on the one-shot path.
        """
        svc = self.service
        fault = classify_fault(exc, table.backend)
        nxt = (fallback_step(table.backend, table.opts, fault, table.nb)
               if fault is not None and svc.policy.fallback else None)
        if nxt is None:
            raise exc
        self.stats[f"fallback_{fault}"] += 1
        new_backend, new_opts = nxt
        ev = ServiceEvent("fallback", {"from": table.backend, "to": new_backend, "fault": fault,
                                       "error": f"{type(exc).__name__}: {exc}"[:200]},
                          time.monotonic())
        table.backend, table.opts = new_backend, dict(new_opts)
        table.degraded = True
        table.events.append(ev)  # later seats inherit the downgrade record
        self._programs_for(table)
        table.stacked = table.bk.stack([s.model if s is not None else table.model0
                                        for s in table.slots])
        for s in table.slots:
            if s is not None:
                s.ticket.events.append(ev)

    def _requeue_quarantined(self, s: _Slot):
        """Per-slot quarantine: retire the poisoned lane, re-autotune its I0
        clamp and send it back through the queue (bounded retries)."""
        svc = self.service
        ticket = s.ticket
        ticket.retries += 1
        ticket.events.append(ServiceEvent(
            "quarantine", {"request": ticket.seq, "chunk": s.chunks_done},
            time.monotonic() - ticket.submit_t))
        self.stats["stream_quarantines"] += 1
        if ticket.retries > svc.policy.max_retries:
            self.stats["quarantine_failures"] += 1
            self._complete_unrun(ticket, STATUS_FAILED, "retries_exhausted")
            return
        hp = ticket.request.hp
        tuned, rep = autotune_hyperparams(ticket._model, hp,
                                          seed=svc.autotune_seed + ticket.retries)
        ticket.request = dataclasses.replace(
            ticket.request, hp=dataclasses.replace(hp, i0_max=tuned.i0_max))
        ticket.events.append(ServiceEvent(
            "retry", {"request": ticket.seq, "attempt": ticket.retries - 1,
                      "i0_max": tuned.i0_max, "z_max": rep.z_max},
            time.monotonic() - ticket.submit_t))
        ticket.status = "queued"
        with self._lock:
            self._queue.append(ticket)

    def _finish(self, table: _SlotTable, s: _Slot, bh: np.ndarray, bm: np.ndarray,
                status: str, reason: str):
        ticket = s.ticket
        now = time.monotonic()
        if status == STATUS_OK and table.degraded:
            status = STATUS_FALLBACK
        ticket.events.append(ServiceEvent(
            "retire", {"request": ticket.seq, "reason": reason, "chunks": s.chunks_done},
            now - ticket.submit_t))
        if status == STATUS_DEADLINE:
            self.stats["deadline_expirations"] += 1
        n = ticket._model.n
        result = AnnealResult(
            best_cut=np.asarray(finalize_cut(bh, s.maxcut)), best_energy=bh,
            best_m=np.asarray(bm)[:, :n], energy_mean=None, energy_min=None, traj=None,
            stored_bits_per_iter=n * table.stored_per_iter, hp=ticket.request.hp)
        resp = AnnealResponse(
            request=ticket.request, result=result, wall_s=now - ticket.submit_t,
            bucket=table.nb, batch=table.n_live + 1, chunks_run=s.chunks_done,
            chunks_total=s.budget, chunk_best_cut=np.asarray(s.trace),
            autotune=ticket.autotune, status=status, events=list(ticket.events),
            lane_wall_s=(now - ticket.t_seated if ticket.t_seated is not None else None),
            queued_s=(ticket.t_seated - ticket.submit_t
                      if ticket.t_seated is not None else None))
        enc = ticket.request.problem
        if isinstance(enc, ProblemEncoding):
            sol, obj, feas = enc.best_feasible(result.best_m)
            resp.solution, resp.objective, resp.feasible = sol, obj, feas
        if s.ckpt is not None and self.service.policy.cleanup_on_success:
            purge_checkpoints(s.ckpt, table.bk1)
        ticket.response = resp
        ticket.status = "done"
        self.stats["stream_completed"] += 1
        self.stats[f"stream_retired_{reason}"] += 1
        ticket._done.set()
