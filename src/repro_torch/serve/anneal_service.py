"""Shape-bucketed annealing service (port of ``repro.serve.anneal_service``):
one cached plateau program serving batched heterogeneous Max-Cut requests,
with a resilience layer that degrades gracefully on any fault below the
request boundary.

The paper's operating mode is "one fixed pipeline, many instances": the
FPGA streams Max-Cut problems through one annealing datapath.  On the GPU:

* **Shape buckets** — problems are zero-padded to power-of-two N
  (:func:`repro_torch.core.engine.bucket_n`, :func:`~repro_torch.core.
  engine.pad_model`), so a heterogeneous stream collapses onto a few shapes.
* **Program cache** — one program per ``(algorithm, backend, options,
  N_bucket, B_bucket, n_trials, n_rnd, noise, storage, Schedule.signature(),
  chunk)``: a batched backend with its init and chunk functions, built once
  per key (``program_cache_misses`` and ``traces_*`` count the builds).
  Problem arrays are arguments, never backend state, so every same-bucket
  group reuses the program.
* **Problem-axis batching** — same-bucket requests are stacked on a leading
  problem axis and advanced together by the batched backends: on
  ``backend='cuda'`` one kernel launch per plateau (K1, K4) or per
  iteration's chain (K2) covers all B problems.  With ``noise='xorshift'``
  each response equals the unpadded single-problem ``anneal()`` on its live
  lanes.
* **Chunked execution with early stop** — the m_shot budget runs in chunks;
  after each chunk the per-request best is reported and a group whose
  requests all reached their ``target_cut`` stops.
* **Packed storage and tiled J** — ``storage_layout='packed'`` carries the
  state between chunks as 32-bit spin words; the dense backend's
  ``j_mode='auto'`` streams (tile_n, N) J slabs above
  ``engine.TILED_J_THRESHOLD`` spins, so G77/G81-class buckets serve
  without a (B, N, N) J.

Resilience: an injected compile fault walks the fallback chain cuda →
dense → sparse, and an out-of-memory fault of the dense backend downgrades
to tiled J first (a real kernel build, launch or memory failure of the
cuda backend raises instead: no plain backend serves in place of a
failing kernel); the downgrade is recorded on ``AnnealResponse.status`` and
``events``.  A per-request ``deadline_s`` returns best-so-far with
``status='deadline'``; a non-finite energy quarantines its request (solo
retry with backoff and a re-autotuned I0max) without touching its
batchmates; admission validation rejects bad requests with
:class:`AdmissionError` before any device work.  With
``ResiliencePolicy(checkpoint_dir=...)`` every chunk boundary saves the
group's state under its :func:`~repro_torch.serve.resilience.
group_fingerprint`, so a killed solve resumes, in a fresh process, from
its last boundary, bit-identically.  Every path is exercised through the
hook points of an attached :class:`repro_torch.ft.faults.FaultInjector`.

Beyond Max-Cut, any :class:`~repro_torch.problems.ProblemEncoding` (QUBO,
MIS, coloring, partition) is served as its Ising model; after the solve
the response carries the decoded best feasible ``solution``, its
``objective`` and the verifier's ``feasible`` verdict.  SA
(:class:`~repro_torch.core.sa.SAHyperParams`) and PT-SSA
(:class:`~repro_torch.core.pt.PTSSAHyperParams`) requests ride the same
entry: SA groups run the batched Metropolis core (no kernel; its chunks
are slices of the cooling ladder, and the fallback chain does not apply),
PT-SSA groups run the plateau scan of the batched sparse or dense backend
(``backend='cuda'`` is rejected at admission: the kernels take a scalar
I0).

Spin sharding: ``partition='spin'`` (or 'auto', per shape bucket) runs SSA
and SSQA groups on :class:`~repro_torch.core.distributed.
BatchedSpinShardedBackend` over ``mesh``, every rank calling ``solve()``
with the same requests and getting the same responses; it is the only way
an instance above ``engine.MAX_UNSHARDED_SPINS`` spins is admitted.  A
spin group's checkpoint holds whole arrays, gathered from the ranks and
written by rank 0; on resume each rank takes its own columns back.  Under
a mesh of several ranks the deadline watchdog reads the slowest rank's
clock, so every rank stops a request at the same chunk.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from ..checkpoint.ckpt import CheckpointManager, latest_step
from ..core.autotune import AutotuneReport, autotune_hyperparams, resolve_hyperparams
from ..core.config import SolverConfig
from ..core.engine import (
    MAX_UNSHARDED_SPINS,
    resolve_partition,
    bucket_n,
    exact_float32_matmul,
    finalize_cut,
    make_batched_backend,
    model_weight_bits,
    next_pow2,
    normalize_problem,
    resolve_backend,
    resolve_device,
    resolve_field_mode,
    schedule_plateaus,
    validate_model,
)
from ..core.ising import IsingModel, MaxCutProblem
from ..core.pt import PTSSAHyperParams, PTSSAResult, pt_ssa_rounds, pt_ssa_swap_keys
from ..core.rng import PRNGKey, xorshift_lanes_ok
from ..core.sa import SAHyperParams, SAResult, sa_cycles_batched, sa_init_batched
from ..core.schedule import sa_temperature_ladder
from ..core.ssa import AnnealResult, SSAHyperParams
from ..core.ssqa import SSQAHyperParams
from ..problems import ProblemEncoding
from ..ft.faults import FaultInjector
from .registry import family_for, registered_algos
from .resilience import (
    STATUS_DEADLINE,
    STATUS_FAILED,
    STATUS_FALLBACK,
    STATUS_OK,
    STATUS_QUARANTINED,
    AdmissionError,
    QuarantineFault,
    ResiliencePolicy,
    ServiceEvent,
    classify_fault,
    fallback_step,
    filter_backend_opts,
    group_fingerprint,
)
from ..sharding import max_over_ranks, mesh_fingerprint

__all__ = ["AnnealRequest", "AnnealResponse", "AnnealProgress", "AnnealService"]

HyperParams = Union[SSAHyperParams, SAHyperParams, PTSSAHyperParams, SSQAHyperParams]


@dataclasses.dataclass(frozen=True)
class AnnealRequest:
    """One problem and its hyper-parameters, as the service accepts it.

    ``problem`` is a Max-Cut instance, an Ising model or a problem
    encoding.  ``hp`` selects the algorithm family through the registry
    (:mod:`repro_torch.serve.registry`): SSAHyperParams → SSA/HA-SSA,
    SSQAHyperParams → SSQA, SAHyperParams → Metropolis SA,
    PTSSAHyperParams → PT on the plateau engine;
    ``algo`` names the family explicitly and is checked against the hp
    type; ``hp='auto'`` autotunes from the instance
    (:mod:`repro_torch.core.autotune`, ``algo='ssqa'`` tunes the ring too).
    ``config`` overrides the service's backend and backend options for this
    request (its noise and storage layout must match the service's); its
    ``signature()`` joins the batching key.  ``target_cut`` arms early stop.
    ``deadline_s`` is the wall-clock budget from the ``solve()`` call: once
    it elapses the request stops at the next chunk boundary with its
    best-so-far and ``status='deadline'``; it never raises.
    """

    problem: Union[MaxCutProblem, IsingModel, ProblemEncoding]
    hp: Union[HyperParams, str] = SSAHyperParams()
    seed: int = 0
    storage: str = "i0max"         # 'i0max' (HA-SSA) | 'all' (SSA)
    schedule_kind: str = "hassa"
    target_cut: Optional[int] = None
    auto_base: Optional[SSAHyperParams] = None  # budget knobs for hp='auto'
    deadline_s: Optional[float] = None
    algo: Optional[str] = None
    config: Optional[SolverConfig] = None


@dataclasses.dataclass
class AnnealResponse:
    request: AnnealRequest
    result: object                 # AnnealResult | SAResult | PTSSAResult | None
    wall_s: float                  # group wall time (the batch solves together)
    bucket: int                    # padded N the request ran at
    batch: int                     # live requests stacked in its group
    chunks_run: int                # chunks executed (early stop may cut short)
    chunks_total: int
    chunk_best_cut: np.ndarray     # (chunks_run,) best-objective trace
    solution: object = None        # decoded domain solution (encoded problems)
    objective: Optional[int] = None  # domain objective of `solution` if feasible
    feasible: Optional[bool] = None  # verifier verdict (None: raw Ising/maxcut)
    autotune: Optional[AutotuneReport] = None  # set when hp='auto' resolved
    status: str = STATUS_OK        # 'ok'|'fallback'|'deadline'|'quarantined'|'failed'|'shed'
    events: List[ServiceEvent] = dataclasses.field(default_factory=list)
    lane_wall_s: Optional[float] = None  # group start → this lane's stop boundary
    queued_s: Optional[float] = None     # streaming: submission → seat


@dataclasses.dataclass(frozen=True)
class AnnealProgress:
    """One progress report (per group, per chunk)."""

    kind: str                      # 'ssa' | 'sa' | 'ptssa' | 'ssqa'
    bucket: int
    chunk: int
    chunks_total: int
    request_indices: tuple         # indices into the solve() request list
    best_cut: tuple                # best objective so far, per request


def _largest_divisor_leq(n: int, k: int) -> int:
    k = max(1, min(int(k), int(n)))
    while n % k:
        k -= 1
    return k


def _opts_key(opts: dict) -> tuple:
    """Hashable projection of backend options for the program-cache key."""
    return tuple(sorted((k, repr(v)) for k, v in opts.items()))


class _LRUCache:
    """Bounded LRU map of built programs.

    Past ``capacity`` the least recently used program is dropped (counted
    in the service's ``program_cache_evictions``); the cache holds the only
    reference to a program's backend, so its device tensors are released
    with it.  Thread-safe: two threads missing on one key may both build;
    the second ``put`` wins.
    """

    def __init__(self, capacity: int, stats: collections.Counter):
        if capacity < 1:
            raise ValueError(f"max_cached_executables must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._od: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self._stats = stats

    def get(self, key):
        with self._lock:
            ent = self._od.get(key)
            if ent is not None:
                self._od.move_to_end(key)
            return ent

    def __setitem__(self, key, ent):
        with self._lock:
            self._od[key] = ent
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self._stats["program_cache_evictions"] += 1

    def __len__(self):
        with self._lock:
            return len(self._od)

    def __contains__(self, key):
        with self._lock:
            return key in self._od

    def __iter__(self):
        with self._lock:
            return iter(list(self._od))

    def values(self):
        with self._lock:
            return list(self._od.values())


class _GroupCtx:
    """Per-attempt execution context of one request group: the effective
    backend (the fallback chain may have downgraded it), the fault hooks,
    the group's checkpoint namespace, and the statuses and events the chunk
    loop gathers."""

    def __init__(self, service: "AnnealService", kind: str, nb: int, items, backend: str,
                 backend_opts: dict, solve_t0: float, chunk: int,
                 events: Optional[List[ServiceEvent]] = None):
        self.kind = kind
        self.backend = backend
        self.backend_opts = dict(backend_opts)
        self.solve_t0 = solve_t0
        self.faults: Optional[FaultInjector] = service.faults
        self.policy: ResiliencePolicy = service.policy
        self.noise = service.noise
        self.events: List[ServiceEvent] = list(events or [])
        self.statuses: dict = {}
        self.ckpt: Optional[CheckpointManager] = None
        self._dir: Optional[str] = None
        self.bk = None  # the group's batched backend: the checkpoints' codec
        if self.policy.checkpoint_dir:
            part = service.partition_for(kind, nb)
            tag = group_fingerprint(kind, nb, backend, service.storage_layout, service.noise,
                                    chunk, items, partition=part,
                                    mesh_fp=mesh_fingerprint(service.mesh) if part == "spin"
                                    else ())
            self._dir = os.path.join(self.policy.checkpoint_dir, tag)
            self.ckpt = CheckpointManager(
                self._dir, save_interval=max(1, int(self.policy.checkpoint_interval)),
                keep=self.policy.keep_checkpoints,
                async_save=False)  # a deterministic crash window

    def fire(self, point: str, **ctx):
        if self.faults is None:
            return None
        return self.faults.fire(point, **ctx)

    def _event(self, kind: str, **detail):
        self.events.append(ServiceEvent(kind, detail, time.perf_counter() - self.solve_t0))

    def maybe_resume(self, template, n_items: int):
        """(start chunk, state, traces): from the latest checkpoint if a
        valid one exists, restored onto the template's devices; else (0,
        template, None).  Zeroed xorshift lanes (the generator's fixed
        point) reject the checkpoint, and the group runs from scratch.  A
        spin group checks the whole restored state, then keeps its columns;
        its ranks resume only where all of them see the same checkpoint and
        accept it (:func:`agreed_latest_step`)."""
        if self.ckpt is None:
            return 0, template, None
        codec = self.bk
        step, split = agreed_latest_step(self._dir, codec)
        if step is None:
            if split:
                self._event("checkpoint_rejected", dir=self._dir, reason=SPLIT_CHECKPOINTS)
            return 0, template, None
        state, meta = self.ckpt.restore_latest(
            codec.checkpoint_state(template) if codec is not None else template)
        traces = meta.get("traces")
        ok = isinstance(traces, list) and len(traces) == n_items
        if ok and self.noise == "xorshift":
            # Batched lanes are (B, 4, T, N): the 4-word axis is axis 1.  An
            # SA carry has no lanes, so under xorshift its checkpoint is
            # rejected and the group runs from scratch, as in the JAX
            # package.
            lanes = getattr(state, "noise_state", None)
            ok = lanes is not None and xorshift_lanes_ok(lanes, axis=1)
        if codec is not None:
            ok = codec.rank_span(int(ok))[0] == 1
        if not ok:
            self._event("checkpoint_rejected", dir=self._dir)
            return 0, template, None
        start = int(meta["step"])
        self._event("resume", chunk=start, dir=self._dir)
        if codec is not None:
            state = codec.restore_state(state)
        return start, state, [list(map(int, t)) for t in traces]

    def save(self, step: int, state, traces):
        if self.ckpt is not None:
            save_checkpoint(self.ckpt, self.bk, step, state, {"traces": traces})

    def finish_success(self):
        if self.ckpt is not None and self.policy.cleanup_on_success:
            purge_checkpoints(self.ckpt, self.bk)


SPLIT_CHECKPOINTS = "the ranks see different checkpoints"


def agreed_latest_step(directory: str, bk):
    """(step, split): the latest checkpoint step of ``directory`` if every
    rank of ``bk``'s group sees the same one (else None), and whether the
    ranks saw different ones.

    Rank 0 of a spin group writes its checkpoints, so its ranks must share
    the checkpoint directory to resume; ranks that do not share it start from
    scratch together instead of resuming at different chunks."""
    seen = latest_step(directory)
    v = -1 if seen is None else seen
    lo, hi = (v, v) if bk is None else bk.rank_span(v)
    return (seen if lo == hi else None), lo != hi


def save_checkpoint(ckpt: CheckpointManager, bk, step: int, state, meta: dict):
    """Save ``state`` through its backend at the checkpoint interval: a
    spin-sharded one gathers the whole arrays, rank 0 alone writes, and the
    ranks wait for it."""
    if bk is None:
        ckpt.maybe_save(step, state, meta=meta)
        return
    if not ckpt.due(step):
        return
    tree = bk.checkpoint_state(state)
    if bk.writes_checkpoints:
        ckpt.maybe_save(step, tree, meta=meta)
    bk.sync()


def purge_checkpoints(ckpt: CheckpointManager, bk):
    """Purge a finished group's checkpoints (rank 0 of a spin group)."""
    if bk is None or bk.writes_checkpoints:
        ckpt.purge()
    if bk is not None:
        bk.sync()


class AnnealService:
    """Batched annealing as a service over the plateau engine.

    One instance owns a backend choice, a noise source, the program cache,
    a :class:`ResiliencePolicy` and a device (``cuda`` unless
    ``device='cpu'``).  ``solve(requests)`` groups requests by (algorithm,
    shape bucket, hyper-parameters), stacks each group on the problem axis
    and runs it through one cached program; a fault below the request
    boundary degrades that group instead of failing the batch.

    Bit-exactness (``noise='xorshift'``): a request solved through the
    service — padded, stacked, chunked — returns the same best energy and
    spins on its live lanes as ``anneal()`` (``anneal_ssqa()``) of the
    unpadded instance.
    """

    def __init__(
        self,
        backend: str = "sparse",
        *,
        noise: str = "xorshift",
        storage_layout: str = "dense",
        chunk_shots: int = 1,
        sa_chunks: int = 8,
        min_bucket: int = 64,
        backend_opts: Optional[dict] = None,
        autotune_seed: int = 0,
        resilience: Optional[ResiliencePolicy] = None,
        faults: Optional[FaultInjector] = None,
        partition: str = "problem",
        mesh=None,
        max_cached_executables: int = 64,
        config: Optional[SolverConfig] = None,
        device=None,
    ):
        """``chunk_shots`` is the chunk width of SSA, SSQA (iterations) and
        PT-SSA (rounds) groups; an SA group runs its cycles in ``sa_chunks``
        chunks (the largest divisor of ``n_cycles`` up to it).
        ``storage_layout='packed'`` keeps the engine state between chunks
        as 32-bit spin words.  ``backend_opts={'field_mode': 'auto'}``
        resolves the XNOR-popcount field per group: a group whose couplings
        fit ``engine.POPCOUNT_AUTO_MAX_BITS`` magnitude planes runs
        popcount (K2 on 'cuda'), with the group's plane count in the
        program key.  ``resilience`` sets fallback and retries (defaults:
        fallback and admission validation on); ``faults`` attaches a fault
        injector (tests and chaos runs only).  ``partition`` picks the
        work-partitioning axis of SSA and SSQA groups: 'problem' stacks
        whole problems on the device; 'spin' shards the spin axis of every
        problem over ``mesh`` (a :class:`repro_torch.sharding.SpinMesh`;
        None: one rank on ``device``), which requires ``noise='xorshift'``;
        'auto' decides per shape bucket.  SA and PT-SSA groups always run
        problem-partitioned.  ``config`` supplies backend, noise, storage
        layout, options, partition and mesh from one
        :class:`~repro_torch.core.config.SolverConfig`, replacing the
        individual arguments.  ``backend='auto'`` resolves per shape
        bucket (``engine.resolve_backend``: 'cuda' from
        ``engine.MIN_RESIDENT_N`` spins, 'dense' below; PT-SSA groups,
        which no kernel runs, 'dense' at every bucket) and keeps the
        options of the backend chosen.  The service turns
        TF32 off for the process
        (:func:`~repro_torch.core.engine.exact_float32_matmul`): its dense
        fields are exact float32 matmuls.
        """
        if config is not None:
            backend = config.backend
            noise = config.noise
            storage_layout = config.storage_layout
            backend_opts = config.engine_opts()
            backend_opts.pop("storage_layout", None)  # passed apart below
            partition = config.partition
            mesh = config.mesh if config.mesh is not None else mesh
        if storage_layout not in ("dense", "packed"):
            raise ValueError(f"unknown storage_layout {storage_layout!r}")
        if partition not in ("problem", "spin", "auto"):
            raise ValueError(f"unknown partition {partition!r}")
        self.backend = backend
        self.noise = noise
        self.storage_layout = storage_layout
        self.chunk_shots = int(chunk_shots)
        self.sa_chunks = int(sa_chunks)       # SA: report and early-stop points per run
        self.min_bucket = int(min_bucket)
        self.autotune_seed = int(autotune_seed)
        self.backend_opts = dict(backend_opts or {})
        self.policy = resilience or ResiliencePolicy()
        self.faults = faults
        self.partition = partition
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        exact_float32_matmul()
        self.stats = collections.Counter()
        self._programs = _LRUCache(max_cached_executables, self.stats)

    def partition_for(self, kind: str, nb: int) -> str:
        """The partition of one group, 'problem' or 'spin'.  Spin sharding
        applies to the plateau families (SSA and SSQA: the replica rings
        live on the trial axis, whole on every rank); SA and PT-SSA run
        through per-problem loops the sharded backend does not expose, so
        they stay problem-partitioned whatever the option."""
        if kind not in ("ssa", "ssqa"):
            return "problem"
        return resolve_partition(self.partition, nb, self.mesh)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def solve(
        self,
        requests: Sequence[AnnealRequest],
        progress: Optional[Callable[[AnnealProgress], None]] = None,
    ) -> List[AnnealResponse]:
        """Solve a batch of heterogeneous requests; responses keep order.

        ``solve([])`` returns ``[]``.  The same request object may appear
        several times (each occurrence gets its own response).  ``hp='auto'``
        requests are resolved before grouping.  Admission validation rejects
        the batch with :class:`AdmissionError` before any device work.
        """
        if not requests:
            return []
        t_solve0 = time.perf_counter()
        self.stats["requests"] += len(requests)
        responses: List[Optional[AnnealResponse]] = [None] * len(requests)
        reports: dict = {}
        groups = collections.defaultdict(list)
        for idx, req in enumerate(requests):
            try:
                maxcut, model = normalize_problem(req.problem)
            except TypeError as e:
                raise AdmissionError(f"request {idx}: {e}") from e
            if self.policy.validate_admission:
                self._admit(idx, req, model)
            if isinstance(req.hp, str):
                hp, reports[idx] = resolve_hyperparams(
                    req.hp, model, base=req.auto_base, seed=self.autotune_seed, algo=req.algo)
                req = dataclasses.replace(req, hp=hp)
                self.stats["autotuned"] += 1
            fam = family_for(req.hp, algo=req.algo)  # raises AdmissionError
            if fam.validate is not None:
                # Family rules are correctness, not hygiene: they hold even
                # with policy.validate_admission off.
                fam.validate(self, idx, req, req.hp)
            nb = bucket_n(model.n, self.min_bucket)
            groups[self._group_key(req, nb)].append((idx, req, maxcut, model))
        self.stats["groups"] += len(groups)
        for key, items in sorted(groups.items(), key=lambda kv: repr(kv[0])):
            self._solve_group_resilient(key[0], key[1], items, responses, progress, t_solve0)
        for idx, resp in enumerate(responses):
            resp.autotune = reports.get(idx)
            if resp.result is not None and isinstance(resp.request.problem, ProblemEncoding):
                sol, obj, feas = resp.request.problem.best_feasible(resp.result.best_m)
                resp.solution, resp.objective, resp.feasible = sol, obj, feas
        return responses  # type: ignore[return-value]

    def cache_info(self) -> dict:
        """Program-cache observability (programs and build counters)."""
        return {
            "programs": len(self._programs),
            "capacity": self._programs.capacity,
            "evictions": self.stats["program_cache_evictions"],
            "keys": sorted(repr(k) for k in self._programs),
            **{k: v for k, v in self.stats.items()},
        }

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def _reject(self, msg: str):
        self.stats["admission_rejects"] += 1
        raise AdmissionError(msg)

    def _admit(self, idx: int, req: AnnealRequest, model: IsingModel):
        try:
            validate_model(model)
        except ValueError as e:
            self.stats["admission_rejects"] += 1
            raise AdmissionError(f"request {idx}: {e}") from e
        if req.deadline_s is not None and not float(req.deadline_s) > 0:
            self._reject(f"request {idx}: deadline_s must be > 0, got {req.deadline_s}")
        if req.config is not None:
            # Noise and storage layout are service-wide contracts: they fix
            # the carried state's format.
            if req.config.noise != self.noise:
                self._reject(f"request {idx}: config.noise={req.config.noise!r} "
                             f"differs from the service's noise={self.noise!r}")
            if req.config.storage_layout != self.storage_layout:
                self._reject(f"request {idx}: config.storage_layout="
                             f"{req.config.storage_layout!r} differs from the service's "
                             f"storage_layout={self.storage_layout!r}")
        if model.n > MAX_UNSHARDED_SPINS:
            # Admissible only when the group will run spin-sharded: on the
            # problem-partitioned path one (N, N)-coupled instance of this
            # size is an out-of-memory hazard, not a request.
            plateau_family = isinstance(req.hp, (SSAHyperParams, str))
            nb = bucket_n(model.n, self.min_bucket)
            if not (plateau_family and self.partition_for("ssa", nb) == "spin"):
                self._reject(f"request {idx}: n={model.n} exceeds the single-device ceiling "
                             f"MAX_UNSHARDED_SPINS={MAX_UNSHARDED_SPINS}; construct the "
                             "service with partition='spin' (or 'auto' on a mesh of several "
                             "ranks, repro_torch.sharding.spin_mesh) to shard the spin axis")

    # ------------------------------------------------------------------
    # Grouping
    # ------------------------------------------------------------------
    def _group_key(self, req: AnnealRequest, nb: int):
        """The family's key plus the request's config signature: requests
        pinned to different execution options never share a program."""
        fam = family_for(req.hp, algo=req.algo)
        cfg_sig = req.config.signature() if req.config is not None else None
        return fam.group_key(req, req.hp, nb) + (cfg_sig,)

    def _resolve_field_opts(self, backend: str, opts: dict, items) -> dict:
        """Resolve field_mode='auto' and the group's ``j_bits``.

        The popcount magnitude-plane count shapes the stacked planes, so the
        group packs every model to its maximum; the resolved values enter
        the options and so the program key.
        """
        if backend not in ("dense", "cuda") or "field_mode" not in opts:
            return dict(opts)
        opts = dict(opts)
        jb = max(model_weight_bits(model) for _, _, _, model in items)
        opts["field_mode"] = resolve_field_mode(opts["field_mode"], jb)
        if opts["field_mode"] == "popcount":
            opts["j_bits"] = max(jb, int(opts.get("j_bits", 1)))
        else:
            opts.pop("j_bits", None)
        return opts

    def _pad_group(self, items):
        """Pad a group to a power-of-two batch (program reuse); the dummy
        slots repeat the first request and their outputs are dropped."""
        b_live = len(items)
        b_bucket = next_pow2(b_live)
        return list(items) + [items[0]] * (b_bucket - b_live), b_live, b_bucket

    # ------------------------------------------------------------------
    # Resilient group dispatch: fallback chain, quarantine, retry
    # ------------------------------------------------------------------
    def _solve_group_resilient(self, kind, nb, items, responses, progress, solve_t0, *,
                               requeue_quarantine: bool = True):
        """Run one group under the resilience wrapper.

        A fault that :func:`classify_fault` classes walks the fallback
        chain and re-runs the group from scratch on the downgraded backend
        (bit-identical: the trajectory depends on the noise, not the
        backend).  A quarantine signal splits the group: healthy requests
        re-run as a fresh group, offenders retry solo.  Kills and
        unclassified errors propagate.
        """
        solver = getattr(self, registered_algos()[kind].solver)
        cfg = items[0][1].config
        if cfg is not None:
            # The group key carries the config signature: every item agrees.
            backend = cfg.backend
            opts = cfg.engine_opts()
            opts.pop("storage_layout", None)
        else:
            backend, opts = self.backend, dict(self.backend_opts)
        if backend == "auto":
            # Per bucket (MIN_RESIDENT_N), keeping only the options of the
            # backend chosen: an 'auto' caller passes their union.  PT-SSA's
            # per-replica I0 has no kernel: its groups take the dense
            # backend, the reference's 'auto' below its 256 spins.
            backend = "dense" if kind == "ptssa" else resolve_backend(backend, nb)
            opts = filter_backend_opts(backend, opts, partition=self.partition_for(kind, nb))
        carried_events: List[ServiceEvent] = []
        while True:
            ctx = _GroupCtx(self, kind, nb, items, backend, opts, solve_t0,
                            self._chunk_of(kind, items), events=carried_events)
            try:
                solver(nb, items, responses, progress, ctx)
            except QuarantineFault as qf:
                if not requeue_quarantine:
                    raise
                self.stats["quarantines"] += 1
                self._handle_quarantine(kind, nb, items, qf, responses, progress, solve_t0)
                return
            except Exception as exc:  # noqa: BLE001 — classified below
                # SA's Metropolis core does not depend on the backend.
                fault = classify_fault(exc, backend) if kind != "sa" else None
                nxt = (fallback_step(backend, opts, fault, nb)
                       if fault is not None and self.policy.fallback else None)
                if nxt is None:
                    raise
                self.stats[f"fallback_{fault}"] += 1
                carried_events = list(ctx.events)
                carried_events.append(ServiceEvent(
                    "fallback",
                    {"from": backend, "to": nxt[0], "fault": fault,
                     "from_opts": dict(opts), "to_opts": dict(nxt[1]),
                     "error": f"{type(exc).__name__}: {exc}"[:200]},
                    time.perf_counter() - solve_t0,
                ))
                backend, opts = nxt
                continue
            default = (STATUS_FALLBACK if any(ev.kind == "fallback" for ev in ctx.events)
                       else STATUS_OK)
            for idx, *_rest in items:
                resp = responses[idx]
                resp.status = ctx.statuses.get(idx, default)
                resp.events = list(ctx.events)
            ctx.finish_success()
            return

    def _chunk_of(self, kind, items) -> int:
        """The group's chunk width (part of its checkpoint fingerprint):
        iterations (SSA, SSQA), rounds (PT-SSA) or cycles (SA) per chunk."""
        hp = items[0][1].hp
        if kind in ("ssa", "ssqa"):
            return _largest_divisor_leq(hp.m_shot, self.chunk_shots)
        if kind == "ptssa":
            return _largest_divisor_leq(hp.n_rounds, self.chunk_shots)
        return hp.n_cycles // _largest_divisor_leq(hp.n_cycles, self.sa_chunks)

    def _handle_quarantine(self, kind, nb, items, qf, responses, progress, solve_t0):
        """Split a poisoned group: healthy slots re-run, offenders go solo."""
        bad = set(qf.slots)
        good = [it for s, it in enumerate(items) if s not in bad]
        if good:
            self._solve_group_resilient(kind, nb, good, responses, progress, solve_t0)
        for s, it in enumerate(items):
            if s in bad:
                self._retry_solo(kind, nb, it, responses, progress, solve_t0)

    def _retry_solo(self, kind, nb, item, responses, progress, solve_t0):
        """A quarantined request: exponential backoff and a re-autotuned
        I0max per attempt; after ``max_retries`` the response comes back
        with ``status='failed'`` (never an exception)."""
        idx, req, maxcut, model = item
        events: List[ServiceEvent] = [ServiceEvent(
            "quarantine", {"request": idx}, time.perf_counter() - solve_t0)]
        hp = req.hp
        for attempt in range(self.policy.max_retries):
            time.sleep(self.policy.backoff_base_s * (2 ** attempt))
            detail = {"request": idx, "attempt": attempt}
            if isinstance(hp, SSAHyperParams):
                tuned, rep = autotune_hyperparams(model, hp,
                                                  seed=self.autotune_seed + attempt + 1)
                hp = dataclasses.replace(hp, i0_max=tuned.i0_max)
                detail.update(i0_max=tuned.i0_max, z_max=rep.z_max)
            events.append(ServiceEvent("retry", detail, time.perf_counter() - solve_t0))
            try:
                self._solve_group_resilient(
                    kind, nb, [(idx, dataclasses.replace(req, hp=hp), maxcut, model)],
                    responses, progress, solve_t0, requeue_quarantine=False)
            except QuarantineFault:
                self.stats["retry_requarantined"] += 1
                continue
            resp = responses[idx]
            resp.status = STATUS_QUARANTINED
            resp.events = events + resp.events
            self.stats["quarantine_recoveries"] += 1
            return
        self.stats["quarantine_failures"] += 1
        responses[idx] = AnnealResponse(
            request=req, result=None, wall_s=time.perf_counter() - solve_t0, bucket=nb,
            batch=1, chunks_run=0, chunks_total=0, chunk_best_cut=np.zeros(0, np.int64),
            status=STATUS_FAILED, events=events)

    # ------------------------------------------------------------------
    # SSA / HA-SSA and SSQA groups
    # ------------------------------------------------------------------
    def _ssa_programs(self, *, nb, b_bucket, hp, storage, schedule_kind, backend, opts,
                      chunk, fire=None, kind="ssa"):
        """The SSA/SSQA program of one (bucket, batch) shape:
        ``(bk, init_fn, chunk_fn, plateaus)`` from the bounded cache, built
        on a miss.  The key leaves out ``m_shot``: the plateau chain of an
        iteration does not depend on the budget.  SSQA groups come with
        ``kind='ssqa'`` and ``opts['n_replicas']``; the schedule signature
        (which carries the J⊥ ramp) and the options keep them apart from
        classical groups."""
        sched = hp.schedule(schedule_kind)
        plateaus = schedule_plateaus(sched, storage)
        part = self.partition_for(kind, nb)
        cache_key = (kind, backend, _opts_key(opts), self.storage_layout, nb, b_bucket,
                     hp.n_trials, hp.n_rnd, self.noise, storage, sched.signature(), chunk,
                     part, mesh_fingerprint(self.mesh) if part == "spin" else ())
        ent = self._programs.get(cache_key)
        if ent is None:
            if fire is not None:
                fire("compile", backend=backend, kind=kind, bucket=nb)
            self.stats["program_cache_misses"] += 1
            bk = make_batched_backend(
                backend, n_bucket=nb, n_trials=hp.n_trials, n_rnd=hp.n_rnd, noise=self.noise,
                storage_layout=self.storage_layout, partition=part, mesh=self.mesh,
                device=self.device, **opts)
            self.stats["traces_init"] += 1
            self.stats["traces_chunk"] += 1

            def init_fn(problem, ns0):
                return bk.init_state(problem, ns0)

            def chunk_fn(problem, state):
                return bk.run_shots(problem, state, plateaus, chunk)

            ent = (bk, init_fn, chunk_fn)
            self._programs[cache_key] = ent
        else:
            self.stats["program_cache_hits"] += 1
        return (*ent, plateaus)

    def _solve_ssa_group(self, nb, items, responses, progress, ctx):
        t0 = time.perf_counter()
        _, req0, _, _ = items[0]
        hp: SSAHyperParams = req0.hp
        chunk = _largest_divisor_leq(hp.m_shot, self.chunk_shots)
        n_chunks = hp.m_shot // chunk

        padded, b_live, b_bucket = self._pad_group(items)
        backend = ctx.backend
        opts = self._resolve_field_opts(backend, ctx.backend_opts, items)
        nr = int(getattr(hp, "n_replicas", 0) or 0)
        if nr:
            # SSQA: the ring depth shapes the program, so it rides the
            # options into the backend and the cache key; the cuda ring
            # modes exist only with streamed noise.
            opts = dict(opts)
            opts["n_replicas"] = nr
            if backend == "cuda":
                opts.setdefault("noise_mode", "streamed")
        bk, init_fn, chunk_fn, plateaus = self._ssa_programs(
            nb=nb, b_bucket=b_bucket, hp=hp, storage=req0.storage,
            schedule_kind=req0.schedule_kind, backend=backend, opts=opts, chunk=chunk,
            fire=ctx.fire, kind=ctx.kind)
        stored_per_iter = sum(p.length for p in plateaus if p.eligible)
        ctx.bk = bk

        stacked = bk.stack([model for _, _, _, model in padded])
        ctx.fire("oom", backend=backend, kind="ssa", bucket=nb, batch=b_bucket,
                 j_mode=getattr(bk, "j_mode", None))
        ns0 = bk.init_noise([req.seed for _, req, _, _ in padded],
                            [model.n for _, _, _, model in padded])
        state = init_fn(stacked, ns0)

        state, chunk_traces, stops = self._chunk_loop(
            ctx.kind, nb, items, n_chunks, progress, lambda st, c: chunk_fn(stacked, st),
            state, lambda st: st.best_H, ctx, width=b_bucket, snap=bk.finalize)
        bh_dev, bm_dev = bk.finalize(state)
        best_H = bh_dev.cpu().numpy()
        best_m = bm_dev.cpu().numpy()
        wall = time.perf_counter() - t0

        for slot, (idx, req, maxcut, model) in enumerate(items):
            stop = stops[slot]
            if stop is not None and stop.get("best_H") is not None:
                bh, bm_full = stop["best_H"], stop["best_m"]
            else:
                bh, bm_full = best_H[slot], best_m[slot]
            result = AnnealResult(
                best_cut=np.asarray(finalize_cut(bh, maxcut)), best_energy=bh,
                best_m=bm_full[:, :model.n], energy_mean=None, energy_min=None, traj=None,
                stored_bits_per_iter=model.n * stored_per_iter, hp=req.hp)
            responses[idx] = AnnealResponse(
                request=req, result=result, wall_s=wall, bucket=nb, batch=b_live,
                chunks_run=len(chunk_traces[slot]), chunks_total=n_chunks,
                chunk_best_cut=np.asarray(chunk_traces[slot]),
                lane_wall_s=(stop["t_abs"] - t0 if stop is not None else wall))

    # ------------------------------------------------------------------
    # SA and PT-SSA groups
    # ------------------------------------------------------------------
    def _respond(self, items, responses, result_cls, best_H, best_m, chunk_traces, stops,
                 n_chunks, nb, b_live, t0, **extra):
        """One response per live slot: its result from the final state, or
        from its own stop boundary when it stopped early."""
        wall = time.perf_counter() - t0
        for slot, (idx, req, maxcut, model) in enumerate(items):
            stop = stops[slot]
            if stop is not None and stop.get("best_H") is not None:
                bh, bm_full = stop["best_H"], stop["best_m"]
            else:
                bh, bm_full = best_H[slot], best_m[slot]
            result = result_cls(
                best_cut=np.asarray(finalize_cut(bh, maxcut)), best_energy=bh,
                best_m=bm_full[:, :model.n], energy_mean=None, energy_min=None,
                hp=req.hp, **extra)
            responses[idx] = AnnealResponse(
                request=req, result=result, wall_s=wall, bucket=nb, batch=b_live,
                chunks_run=len(chunk_traces[slot]), chunks_total=n_chunks,
                chunk_best_cut=np.asarray(chunk_traces[slot]),
                lane_wall_s=(stop["t_abs"] - t0 if stop is not None else wall))

    def _solve_sa_group(self, nb, items, responses, progress, ctx):
        """Metropolis SA of a group on the sparse stacking: each chunk is a
        slice of the cooling ladder, the keys ride in the carry, and each
        problem proposes only its live spins."""
        t0 = time.perf_counter()
        hp: SAHyperParams = items[0][1].hp
        n_chunks = _largest_divisor_leq(hp.n_cycles, self.sa_chunks)
        chunk_cycles = hp.n_cycles // n_chunks

        padded, b_live, b_bucket = self._pad_group(items)
        cache_key = ("sa", nb, b_bucket, hp.n_trials, chunk_cycles)
        stacker = self._programs.get(cache_key)
        if stacker is None:
            ctx.fire("compile", backend="sa-core", kind="sa", bucket=nb)
            self.stats["program_cache_misses"] += 1
            self.stats["traces_init"] += 1
            self.stats["traces_chunk"] += 1
            # SA reuses the sparse stacking (gather-based ΔH).
            stacker = make_batched_backend("sparse", n_bucket=nb, n_trials=hp.n_trials,
                                           noise="xorshift", device=self.device)
            self._programs[cache_key] = stacker
        else:
            self.stats["program_cache_hits"] += 1
        pr = stacker.stack([model for _, _, _, model in padded])
        keys = np.asarray([PRNGKey(req.seed) for _, req, _, _ in padded], np.int64)
        n_lives = [model.n for _, _, _, model in padded]
        temps = sa_temperature_ladder(hp.t_start, hp.t_end, hp.n_cycles)
        carry = sa_init_batched(pr["h"], pr["nbr_idx"], pr["nbr_w"], keys,
                                n_trials=hp.n_trials)

        def step(ca, c):
            ca, _ = sa_cycles_batched(pr["h"], pr["nbr_idx"], pr["nbr_w"], ca,
                                      temps[c * chunk_cycles:(c + 1) * chunk_cycles],
                                      n_live=n_lives)
            return ca

        carry, chunk_traces, stops = self._chunk_loop(
            "sa", nb, items, n_chunks, progress, step, carry, lambda ca: ca.best_H, ctx,
            width=b_bucket, snap=lambda ca: (ca.best_H, ca.best_m))
        self._respond(items, responses, SAResult, carry.best_H.cpu().numpy(),
                      carry.best_m.cpu().numpy(), chunk_traces, stops, n_chunks, nb, b_live, t0)

    def _solve_ptssa_group(self, nb, items, responses, progress, ctx):
        """PT-SSA of a group on the batched sparse or dense backend: each
        chunk runs ``chunk`` plateau+swap rounds, every problem swapping
        under its own keys (those of ``anneal_pt_ssa`` of its seed)."""
        t0 = time.perf_counter()
        hp: PTSSAHyperParams = items[0][1].hp
        backend = ctx.backend
        if backend == "cuda":
            raise ValueError(
                "pt-ssa needs per-replica I0 columns; run the service with "
                "backend='sparse' or 'dense' for PTSSAHyperParams requests")
        chunk = _largest_divisor_leq(hp.n_rounds, self.chunk_shots)
        n_chunks = hp.n_rounds // chunk

        padded, b_live, b_bucket = self._pad_group(items)
        opts = self._resolve_field_opts(backend, ctx.backend_opts, items)
        cache_key = ("ptssa", backend, _opts_key(opts), nb, b_bucket, hp, self.noise, chunk)
        bk = self._programs.get(cache_key)
        if bk is None:
            ctx.fire("compile", backend=backend, kind="ptssa", bucket=nb)
            self.stats["program_cache_misses"] += 1
            self.stats["traces_init"] += 1
            self.stats["traces_chunk"] += 1
            bk = make_batched_backend(backend, n_bucket=nb, n_trials=hp.n_replicas,
                                      n_rnd=hp.n_rnd, noise=self.noise, device=self.device,
                                      **opts)
            self._programs[cache_key] = bk
        else:
            self.stats["program_cache_hits"] += 1
        pr = bk.stack([model for _, _, _, model in padded])
        ctx.fire("oom", backend=backend, kind="ptssa", bucket=nb, batch=b_bucket,
                 j_mode=getattr(bk, "j_mode", None))
        state = bk.init_state(pr, bk.init_noise([req.seed for _, req, _, _ in padded],
                                                [model.n for _, _, _, model in padded]))
        # The swap keys of anneal_pt_ssa, sliced per chunk: chunked runs
        # equal unchunked ones.
        all_keys = np.stack([pt_ssa_swap_keys(req.seed, hp.n_rounds)
                             for _, req, _, _ in padded])    # (B, n_rounds, 2)
        parities = np.arange(hp.n_rounds, dtype=np.int32) % 2
        field_fn = functools.partial(bk._field, pr)

        def step(st, c):
            sl = slice(c * chunk, (c + 1) * chunk)
            return pt_ssa_rounds(field_fn, bk._noise_step, pr["h"][:, None], hp, st,
                                 all_keys[:, sl], parities[sl])

        state, chunk_traces, stops = self._chunk_loop(
            "ptssa", nb, items, n_chunks, progress, step, state, lambda st: st.best_H, ctx,
            width=b_bucket, snap=lambda st: (st.best_H, st.best_m))
        self._respond(items, responses, PTSSAResult, state.best_H.cpu().numpy(),
                      state.best_m.cpu().numpy(), chunk_traces, stops, n_chunks, nb, b_live, t0)

    # ------------------------------------------------------------------
    # The chunk loop: best_H reports, early stop, deadline watchdog,
    # non-finite detector, fault hooks
    # ------------------------------------------------------------------
    def _chunk_loop(self, kind, nb, items, n_chunks, progress, step, state, best_of, ctx, *,
                    width=None, snap=None):
        """Run up to ``n_chunks`` ``step(state, c)`` calls from the last
        checkpoint; report per-chunk bests; stop early when every request
        is done (target reached or deadline expired).

        Each chunk boundary saves the state (when checkpoints are on), then
        fires the 'kill' hook: a kill escapes with the boundary saved.

        A request that stops early has its trace and its result frozen at
        its own chunk boundary (``snap`` reads best_H/best_m there), even
        while the rest of the group goes on.  Returns (state, traces,
        stops): one stop record per lane, ``{'chunk', 't_abs'[, 'best_H',
        'best_m']}``, or None for a lane that ran to the group's end.
        """
        traces = [[] for _ in items]
        start, state, restored = ctx.maybe_resume(state, len(items))
        if restored is not None:
            traces = restored
        done = [False] * len(items)
        frozen = [False] * len(items)
        stops: List[Optional[dict]] = [None] * len(items)
        watch = any(req.deadline_s is not None for _, req, _, _ in items)
        for c in range(start, n_chunks):
            self.stats["slot_chunks"] += width if width is not None else len(items)
            self.stats["live_lane_chunks"] += sum(1 for s in range(len(items)) if not done[s])
            state = step(state, c)
            best_H = best_of(state).cpu().numpy()  # the report: a device sync
            # Non-finite watchdog.  The 'nan' hook corrupts the detector's
            # float view of the readings of the slots it names.
            readings = best_H.astype(np.float64)
            spec = ctx.fire("nan", kind=kind, chunk=c)
            if spec is not None:
                for s in (spec.slots or range(len(items))):
                    if s < len(items):
                        readings[s] = np.nan
            bad = tuple(s for s in range(len(items)) if not np.all(np.isfinite(readings[s])))
            if bad:
                self.stats["nonfinite_detected"] += 1
                raise QuarantineFault(bad)
            bests = []
            for slot, (idx, req, maxcut, model) in enumerate(items):
                best = int(np.max(np.asarray(finalize_cut(best_H[slot], maxcut))))
                if not frozen[slot]:
                    traces[slot].append(best)
                bests.append(best)
            self.stats["chunks_run"] += 1
            if progress is not None:
                progress(AnnealProgress(
                    kind=kind, bucket=nb, chunk=c, chunks_total=n_chunks,
                    request_indices=tuple(idx for idx, *_ in items), best_cut=tuple(bests)))
            now = time.perf_counter()
            elapsed = (max_over_ranks(self.mesh, [now - ctx.solve_t0])[0] if watch
                       else 0.0)
            newly: List[int] = []
            ctx.save(c + 1, state, traces)
            ctx.fire("kill", kind=kind, chunk=c)
            for slot, (idx, req, _, _) in enumerate(items):
                if done[slot]:
                    continue
                if req.target_cut is not None and bests[slot] >= req.target_cut:
                    done[slot] = frozen[slot] = True
                    stops[slot] = {"chunk": c + 1, "t_abs": now}
                    newly.append(slot)
                elif req.deadline_s is not None and elapsed >= req.deadline_s:
                    done[slot] = frozen[slot] = True
                    stops[slot] = {"chunk": c + 1, "t_abs": now}
                    newly.append(slot)
                    ctx.statuses[idx] = STATUS_DEADLINE
                    ctx._event("deadline", request=idx, chunk=c, best=bests[slot])
                    self.stats["deadline_expirations"] += 1
            group_ends = (c + 1 == n_chunks) or all(done)
            if newly and not group_ends and snap is not None:
                # The group goes on past these lanes' stop: freeze their
                # result here, so later chunks cannot change it.
                bh_s, bm_s = (t.cpu().numpy() for t in snap(state))
                for slot in newly:
                    stops[slot]["best_H"] = bh_s[slot].copy()
                    stops[slot]["best_m"] = bm_s[slot].copy()
            if all(done) and c + 1 < n_chunks:
                self.stats["early_stops"] += 1
                break
        return state, traces, stops
