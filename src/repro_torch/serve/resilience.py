"""Resilience policy of the annealing service (port of
``repro.serve.resilience``).

What the service needs to degrade gracefully instead of failing a batch:
the policy knobs (:class:`ResiliencePolicy`), the typed admission errors,
the fault taxonomy (:func:`classify_fault`), the backend fallback chain
(:func:`fallback_step`), the structured event records
(:class:`ServiceEvent`) and the stable group fingerprint that keys
chunk-level checkpoints (:func:`group_fingerprint`).

All live state between plateau chunks is a small explicit buffer (spin
words, the carried xorshift lanes, ``best_H`` and the chunk index), so
checkpoint/resume and group re-execution are bit-identical.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.engine import resolve_j_mode
from ..ft.faults import InjectedCompileFailure, InjectedKill, InjectedOOM

__all__ = [
    "STATUS_OK",
    "STATUS_FALLBACK",
    "STATUS_DEADLINE",
    "STATUS_QUARANTINED",
    "STATUS_FAILED",
    "STATUS_SHED",
    "AdmissionError",
    "QueueFullError",
    "QuarantineFault",
    "ServiceEvent",
    "ResiliencePolicy",
    "classify_fault",
    "fallback_step",
    "filter_backend_opts",
    "group_fingerprint",
]

# AnnealResponse.status values.
STATUS_OK = "ok"                    # solved on the configured backend
STATUS_FALLBACK = "fallback"        # solved after >= 1 backend/j_mode downgrade
STATUS_DEADLINE = "deadline"        # deadline expired; best-so-far returned
STATUS_QUARANTINED = "quarantined"  # non-finite detection; solved solo on retry
STATUS_FAILED = "failed"            # retries exhausted; no result
STATUS_SHED = "shed"                # streaming: dropped from the queue unstarted
#                                     (deadline already unmeetable); no result


class AdmissionError(ValueError):
    """A request rejected at admission (bad weights, absurd shape, bad
    knobs), before any group starts solving: a rejected batch does no
    device work."""


class QueueFullError(AdmissionError):
    """Streaming admission control: the request queue is at capacity.

    Raised by :meth:`repro_torch.serve.stream.StreamingAnnealService.submit`
    when the queue's depth or aggregate cost bound is hit; subclasses
    :class:`AdmissionError`, so clients treat both as "not accepted".
    """


class QuarantineFault(RuntimeError):
    """Internal signal: non-finite readings in some batch slots.

    Carries the group-slot indices of the offending requests; the service
    re-runs the healthy slots as a fresh group (bit-identical: per-problem
    lanes are independent) and retries the offenders solo.
    """

    def __init__(self, slots: Tuple[int, ...]):
        super().__init__(f"non-finite energies in batch slots {sorted(slots)}")
        self.slots = tuple(slots)


@dataclasses.dataclass(frozen=True)
class ServiceEvent:
    """One structured resilience event, attached to the responses it touched.

    ``kind``: 'fallback' | 'resume' | 'deadline' | 'quarantine' | 'retry'
    | 'checkpoint_rejected', and the streaming lifecycle kinds 'seat' |
    'retire' | 'shed' | 'retries_exhausted'.  ``t`` is seconds since the
    ``solve()`` call began (streaming: since submission).  Events are
    group-scoped (every response of the group carries the group's events)
    except quarantine and retry, which are per request.
    """

    kind: str
    detail: Dict[str, object]
    t: float


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Service-level failure-handling knobs.

    checkpoint_dir:      root of chunk-level group checkpoints (None = off);
                         each request group writes under
                         ``<dir>/<group_fingerprint>/``.  Rank 0 of a spin
                         group writes for all its ranks, so they must share
                         this directory to resume; ranks that see different
                         checkpoints start from scratch together.
    checkpoint_interval: save every k-th chunk boundary.
    keep_checkpoints:    keep the last n per group (crash window = interval).
    cleanup_on_success:  purge a group's checkpoints when it completes.
    fallback:            enable the backend fallback chain
                         (cuda → dense → sparse, dense-J → tiled-J on OOM);
                         the cuda backend enters it on injected faults only
                         (:func:`classify_fault`).
    max_retries:         solo retries of a quarantined request.
    backoff_base_s:      exponential-backoff base of those retries.
    validate_admission:  reject non-finite weights, absurd shapes and bad
                         knobs with :class:`AdmissionError` before solving.
    """

    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 1
    keep_checkpoints: int = 2
    cleanup_on_success: bool = True
    fallback: bool = True
    max_retries: int = 3
    backoff_base_s: float = 0.05
    validate_admission: bool = True


# Constructor keywords each batched backend takes beyond the common set: the
# fallback drops the others when it downgrades.  Both field-capable backends
# take field_mode/j_bits, so a cuda → dense downgrade keeps the popcount
# arithmetic, and j_dtype, so it keeps J's dtype (dense J → tiled J ignores
# it); every backend takes n_replicas, so no step turns SSQA into SSA.
_BACKEND_OPT_KEYS = {
    "sparse": frozenset({"n_replicas"}),
    "dense": frozenset({"j_dtype", "j_mode", "tile_n", "field_mode", "j_bits",
                        "double_buffer", "n_replicas"}),
    "cuda": frozenset({"j_dtype", "noise_mode", "field_mode", "j_bits", "n_replicas"}),
    # partition='spin': the spin-sharded backend wraps any base field style
    # and accepts (and ignores) the single-device knobs, so the fallback
    # chain walks cuda → dense → sparse under spin sharding too.  The JAX
    # package's keyset, its 'pallas' knobs included.
    "spinshard": frozenset({"j_dtype", "j_mode", "tile_n", "field_mode", "j_bits",
                            "double_buffer", "block_r", "interpret", "noise_mode",
                            "n_replicas"}),
}


def filter_backend_opts(backend: str, opts: dict, *, partition: str = "problem") -> dict:
    """Project backend options onto what ``backend`` accepts.  Under
    ``partition='spin'`` the group runs on the spin-sharded backend whatever
    the base backend's name, so its wider keyset applies."""
    if partition == "spin":
        backend = "spinshard"
    keys = _BACKEND_OPT_KEYS.get(backend, frozenset())
    return {k: v for k, v in opts.items() if k in keys}


def classify_fault(exc: BaseException, backend: str) -> Optional[str]:
    """Map an exception of a group solve to a fault class: 'oom',
    'compile', or None (not recoverable by fallback: it propagates).

    Injected kills, quarantine signals and admission errors are never
    classified; an injected OOM or compile failure always is.  On the
    'cuda' backend nothing else is: a kernel that does not build
    (:class:`~repro_torch.kernels._build.KernelBuildError`), does not launch
    (:class:`~repro_torch.kernels.ssa_update.KernelLaunchError`) or runs
    out of device memory raises to the caller, so no plain-PyTorch backend
    ever serves in place of a failing kernel.  On the plain backends a
    device allocation failure (``torch.cuda.OutOfMemoryError``,
    ``MemoryError``, an "out of memory" message) is 'oom': dense-J →
    tiled-J → sparse.
    """
    if isinstance(exc, (InjectedKill, QuarantineFault, AdmissionError, KeyboardInterrupt)):
        return None
    if isinstance(exc, InjectedOOM):
        return "oom"
    if isinstance(exc, InjectedCompileFailure):
        return "compile"
    if backend == "cuda":
        return None
    if (isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError))
            or "out of memory" in str(exc).lower()):
        return "oom"
    return None


def fallback_step(backend: str, opts: dict, fault: str,
                  n_bucket: int) -> Optional[Tuple[str, dict]]:
    """One step down the fallback chain; None = chain exhausted.

    compile/launch: cuda → dense → sparse.  Out of memory on the dense
    backend with a held J: dense-J → tiled-J first (same backend, another
    program), then sparse.
    """
    if backend == "dense" and fault == "oom":
        if resolve_j_mode(opts.get("j_mode", "auto"), n_bucket) != "tiled":
            return "dense", {**filter_backend_opts("dense", opts), "j_mode": "tiled"}
        return "sparse", filter_backend_opts("sparse", opts)
    if backend == "cuda":
        return "dense", filter_backend_opts("dense", opts)
    if backend == "dense":
        return "sparse", filter_backend_opts("sparse", opts)
    return None


def group_fingerprint(kind: str, n_bucket: int, backend: str, storage_layout: str,
                      noise: str, chunk: int, items, *, partition: str = "problem",
                      mesh_fp: tuple = ()) -> str:
    """Stable identity of a request group, the key of its checkpoints.

    Hashes the execution configuration and, per request, the seed, the
    request's knobs and the problem arrays themselves, so a ``solve()`` in
    a fresh process maps onto an interrupted run's checkpoints iff it would
    replay the same computation.  The hashed ``repr`` tuples and array
    bytes are the JAX package's: equal requests on the sparse and dense
    backends give its digest (the backend name is hashed, so 'cuda' and
    'pallas' differ).  ``partition``/``mesh_fp`` fold the spin-sharding
    layout in: a checkpoint written by a spin-sharded group on one mesh must
    not be resumed under another (the state's values do not depend on the
    layout, but mixing layouts silently would hide a rank-count mistake).
    """
    hsh = hashlib.sha256()
    hsh.update(repr((kind, n_bucket, backend, storage_layout, noise, chunk, partition,
                     mesh_fp)).encode())
    for _idx, req, _maxcut, model in items:
        cfg = getattr(req, "config", None)
        hsh.update(repr((req.seed, req.storage, req.schedule_kind, req.target_cut, req.hp,
                         cfg.signature() if cfg is not None else None,
                         getattr(req, "algo", None))).encode())
        for arr in (model.h, model.nbr_idx, model.nbr_w):
            a = np.ascontiguousarray(np.asarray(arr))
            hsh.update(str(a.dtype).encode())
            hsh.update(a.tobytes())
    return hsh.hexdigest()[:20]
