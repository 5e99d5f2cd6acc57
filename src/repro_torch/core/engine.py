"""Plateau-structured annealing engine (port of ``repro.core.engine``).

HA-SSA treats the temperature *plateau* — τ cycles at constant I0 — as the
unit of execution and of storage: the write-enable is a per-plateau
predicate (I0 == I0max).  The engine advances one plateau at a time through
a pluggable :class:`PlateauBackend`:

* :class:`SparseBackend` / :class:`DenseBackend` — a Python loop over the
  cycles of a plateau (:func:`run_plateau_scan`), one field contraction per
  cycle: the field of the update of m(t) is reused for H(m(t)).
* :class:`CudaBackend` — a resident CUDA plateau kernel, one launch per
  plateau (with ``field_mode='popcount'``, one launch of K2 per plateau
  chain; SSQA plateaus with J⊥ ≠ 0 run the kernels' ring modes): with
  streamed noise K1
  (:func:`repro_torch.kernels.ssa_update.ssa_plateau_packed_batched` at B
  = 1: spins packed at the launch boundary, the xorshift noise stepped
  inside the kernel), with pregenerated noise K4
  (:func:`repro_torch.kernels.ssa_update.ssa_plateau_batched` at B = 1: a
  (C, T, N) noise buffer drawn before the launch — always for threefry, on
  request for xorshift).  The dispatch of K1, K4 and K2 is one
  (:class:`_CudaDispatch`), shared with :class:`BatchedCudaBackend`, which
  makes the same launches at B > 1.  Plateaus that must emit per-cycle
  outputs (energy traces, trajectory planes) run the cycle loop over the
  CUDA field kernel K3 instead.

Tracking semantics, shared by every backend and by the kernels: within a
plateau that starts at m(t0), the states it produces, m(t0+1) … m(t0+C),
are folded into the running best under the plateau's eligibility; m(t0)
belongs to the previous plateau, and the final state is folded by one
extra field evaluation after the loop.

SSQA (a backend built with ``n_replicas``): the trial axis holds T/R
Trotter rings of R consecutive replicas, and a plateau's J⊥ adds
``J⊥ · (m[k-1] + m[k+1])`` (:func:`replica_coupling`) to the update field
only; best tracking and energy traces keep the classical energy.

Field arithmetic (``field_mode``): 'dense' contracts the (N, N) J;
'popcount' contracts the coupling bitplanes of ``kernels.bitplane.PackedJ``
by XNOR-popcount, integers only, and holds no J at all; 'auto' picks
popcount up to POPCOUNT_AUTO_MAX_BITS magnitude planes.  Results are
bit-identical.

Storage layouts: 'dense' keeps :class:`EngineState` (int8 spins), 'packed'
keeps :class:`PackedEngineState` (32-bit words, see ``kernels.bitplane``).
Results are bit-identical.

Serving (``repro_torch.serve``): :func:`bucket_n` and :func:`pad_model` pad
a problem to a power-of-two bucket, :func:`padded_noise_init` keeps the
live xorshift lanes padding-invariant, and the batched backends
(:func:`make_batched_backend`) advance B stacked problems together —
:class:`BatchedCudaBackend` with one kernel launch per plateau or chain
for all B.

Spin sharding: ``partition='spin'`` (or 'auto' on a mesh of several ranks,
:func:`resolve_partition`) routes :func:`make_backend` and
:func:`make_batched_backend` to :mod:`repro_torch.core.distributed`, which
splits one problem's spins over the ranks of a ``torch.distributed`` group.

Tensors live on the backend's ``device``: ``cuda`` unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import ssa_update as kssa
from ..kernels.bitplane import (
    PackedJ,
    adjacency_weight_bits,
    pack_couplings_from_adjacency,
    pack_spins,
    unpack_spins,
)
from ..kernels.ref import replica_coupling
from ..sharding import mesh_axis_size as spin_axis_size  # the JAX package's name here
from .config import SolverConfig
from .ising import (
    _F32_EXACT_BOUND,
    IsingModel,
    MaxCutProblem,
    local_fields_dense,
    local_fields_popcount,
    local_fields_sparse,
    local_fields_tiled,
)
from .rng import (
    threefry_key,
    threefry_noise,
    threefry_noise_cycles,
    threefry_split,
    xorshift_init,
    xorshift_init_slice,
    xorshift_next_bits,
    xorshift_noise_cycles,
)
from .schedule import Schedule

__all__ = [
    "BIG_ENERGY",
    "TILED_J_THRESHOLD",
    "POPCOUNT_TILE_N",
    "MIN_RESIDENT_N",
    "J_DTYPES",
    "MAX_MODEL_SPINS",
    "MAX_UNSHARDED_SPINS",
    "SPIN_SHARD_MIN_N",
    "POPCOUNT_AUTO_MAX_BITS",
    "BaseResult",
    "EngineState",
    "PackedEngineState",
    "pack_state",
    "unpack_state",
    "Plateau",
    "PlateauBackend",
    "SparseBackend",
    "DenseBackend",
    "CudaBackend",
    "BACKENDS",
    "make_backend",
    "resolve_device",
    "resolve_backend",
    "resolve_j_dtype",
    "resolve_field_mode",
    "resolve_j_mode",
    "resolve_noise_mode",
    "resolve_partition",
    "spin_axis_size",
    "model_weight_bits",
    "plateau_cycle_schedules",
    "replica_coupling",
    "normalize_problem",
    "validate_model",
    "finalize_cut",
    "schedule_plateaus",
    "tile_plateaus",
    "run_plateau_scan",
    "run_schedule",
    "ssa_cycle_update",
    "energy_from_field",
    "pack_spins",
    "unpack_spins",
    "exact_float32_matmul",
    "next_pow2",
    "bucket_n",
    "pad_model",
    "pad_degree",
    "padded_noise_init",
    "padded_noise_init_slice",
    "extract_slot",
    "splice_slot",
    "BatchedBackend",
    "BatchedSparseBackend",
    "BatchedDenseBackend",
    "BatchedCudaBackend",
    "BATCHED_BACKENDS",
    "make_batched_backend",
]

# Sentinel "no solution yet" energy (any real H is far below this).
BIG_ENERGY = 2**30

# j_mode='auto' streams J in (tile_n, N) slabs above this spin count instead
# of holding the dense (N, N) matrix (f32 J is 64 MB at N=4096).  The popcount
# field row-tiles its contraction above the same count, POPCOUNT_TILE_N (the
# default tile_n) rows at a time.
TILED_J_THRESHOLD = 4096
POPCOUNT_TILE_N = 512

# field_mode='auto' uses the XNOR-popcount contraction up to this many
# magnitude bitplanes (the paper's hardware is 4-bit); wider integer weights
# take the dense contraction, whose cost does not grow with the bit depth.
POPCOUNT_AUTO_MAX_BITS = 4

# backend='auto' runs the resident CUDA kernels from this many spins on and
# the dense backend below.  Re-derived on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §5, the crossover table; benchmarks/crossover.py): at Table II
# widths the cuda backend was faster than the dense one at every size
# measured, 16 to 2048 spins, through anneal() and the service (the dense
# backend's cycle loop is host-bound, ~0.2-0.3 s a 600-cycle call), so the
# threshold is the smallest size measured.  The TPU's 256 does not carry over.
MIN_RESIDENT_N = 16

# The dtypes J may be held in (``j_dtype``), on the dense and the cuda
# backends alike: every dtype the JAX package's dense and pallas backends
# run.  The field is float32 m @ float32(J), J rounded or wrapped into its
# dtype first, as ``jnp.asarray(J, j_dtype)`` does (K1, K1's ring mode and
# K4 widen it to float32 on load, K3 to int32: csrc/jtype.cuh); a 64-bit
# dtype is held in 32 bits, as jax does with its 64-bit types off.
J_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.uint8,
            torch.int16, torch.int32)
_J_32BIT = {torch.float64: torch.float32, torch.int64: torch.int32}

# Admission ceiling on the spin count: rejects a corrupted shape early.
MAX_MODEL_SPINS = 1 << 22

# The service admits no instance above this many spins on one device: a
# single (N, N)-coupled instance there belongs to spin sharding
# (partition='spin'), as in the JAX package.
MAX_UNSHARDED_SPINS = 1 << 15

# partition='auto' shards the spin axis over a mesh of several ranks only
# at or above this many spins: below it the per-cycle all-gather outweighs
# the O(N·Ns) shard contraction it buys.
SPIN_SHARD_MIN_N = 2048


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another.  Asking for ``cuda`` without a GPU raises; nothing falls back
    to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# The p-bit update (Eq. 2a–2c) and the energy, shared by every backend
# ---------------------------------------------------------------------------
def ssa_cycle_update(field, itanh, r, i0, n_rnd):
    """Elementwise epilogue of one SSA cycle.

    Args:
      field: int32[..., N]  h_i + Σ_j J_ij m_j(t)
      itanh: int32[..., N]  Itanh_i(t)
      r:     int32[..., N]  noise in {-1,+1}
      i0:    int            pseudo-inverse temperature I0(t), or an int32
                            tensor broadcasting against ``field`` (PT-SSA's
                            per-replica I0 column)
      n_rnd: int            noise magnitude
    Returns:
      (m_new int8[..., N], itanh_new int32[..., N])
    """
    I = field + n_rnd * r + itanh  # noqa: E741 — Eq. (2a) current
    itanh_new = torch.clamp(I, -i0, i0 - 1)                        # (2b)
    m_new = torch.where(itanh_new >= 0, 1, -1).to(torch.int8)      # (2c)
    return m_new, itanh_new


def energy_from_field(m, field, h):
    """H = -(h·m + m·field)/2, exact int32 (field = h + Jm; the sum is even)."""
    m32 = m.to(torch.int32)
    hm = (h * m32).sum(dim=-1, dtype=torch.int32)
    mf = (m32 * field).sum(dim=-1, dtype=torch.int32)
    return -(hm + mf) // 2


# ---------------------------------------------------------------------------
# Problem / result plumbing
# ---------------------------------------------------------------------------
def normalize_problem(
    problem: Union[MaxCutProblem, IsingModel, Any],
) -> Tuple[Optional[MaxCutProblem], IsingModel]:
    """Split a problem into (maxcut-or-None, IsingModel).

    Accepts a :class:`MaxCutProblem`, an :class:`IsingModel`, or any object
    whose ``model`` attribute is an IsingModel.
    """
    if isinstance(problem, MaxCutProblem):
        return problem, problem.to_ising()
    if isinstance(problem, IsingModel):
        return None, problem
    model = getattr(problem, "model", None)
    if isinstance(model, IsingModel):
        return None, model
    raise TypeError(
        f"cannot interpret {type(problem).__name__} as an annealing problem; "
        "pass a MaxCutProblem, an IsingModel, or an object with a .model"
    )


def validate_model(model: IsingModel, *, max_spins: int = MAX_MODEL_SPINS):
    """Structural validation of an Ising model; raises ValueError."""
    n = int(model.n)
    if n <= 0:
        raise ValueError(f"model {model.name!r}: need n > 0, got {n}")
    if n > max_spins:
        raise ValueError(
            f"model {model.name!r}: n={n} exceeds the ceiling {max_spins}"
        )
    h = np.asarray(model.h)
    idx = np.asarray(model.nbr_idx)
    w = np.asarray(model.nbr_w)
    if h.shape != (n,):
        raise ValueError(f"model {model.name!r}: h shape {h.shape} != ({n},)")
    if idx.ndim != 2 or idx.shape[0] != n or idx.shape != w.shape:
        raise ValueError(
            f"model {model.name!r}: adjacency shapes nbr_idx {idx.shape} / "
            f"nbr_w {w.shape} inconsistent with n={n}"
        )
    for name, arr in (("h", h), ("nbr_w", w)):
        if not np.all(np.isfinite(arr.astype(np.float64, copy=False))):
            raise ValueError(f"model {model.name!r}: non-finite values in {name}")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(f"model {model.name!r}: neighbor indices outside [0, {n})")


def finalize_cut(best_H, maxcut: Optional[MaxCutProblem]):
    """Map best Ising energies to the reported objective (cut or -H)."""
    if maxcut is not None:
        return (maxcut.w_total - best_H) // 2
    return -best_H


@dataclasses.dataclass
class BaseResult:
    """Outcome fields of an annealing run (numpy, on the host)."""

    best_cut: np.ndarray          # best objective per trial (cut for maxcut)
    best_energy: np.ndarray       # Ising energy of the best tracked state
    best_m: np.ndarray            # spins of the best tracked state
    energy_mean: Optional[np.ndarray]  # per-cycle mean H over trials
    energy_min: Optional[np.ndarray]   # per-cycle min H over trials

    @property
    def overall_best_cut(self) -> int:
        return int(np.max(self.best_cut))

    @property
    def mean_best_cut(self) -> float:
        return float(np.mean(self.best_cut))


# ---------------------------------------------------------------------------
# Plateaus: the schedule grouped into its execution unit
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Plateau:
    """One constant-I0 run of cycles.  ``eligible`` is the storage
    write-enable for the states this plateau produces; ``jperp`` the SSQA
    replica coupling J⊥ held over it (0, the classical value, disables the
    coupling)."""

    i0: int
    length: int
    eligible: bool
    jperp: int = 0


def schedule_plateaus(sched: Schedule, storage: str = "i0max") -> Tuple[Plateau, ...]:
    """Group one iteration's per-cycle schedule into plateaus, split where
    I0, eligibility or J⊥ changes.

    storage='i0max' → HA-SSA eligibility; storage='all' → every plateau
    eligible (conventional SSA).
    """
    i0 = np.asarray(sched.i0_per_cycle)
    if storage == "i0max":
        elig = np.asarray(sched.store_mask)
    elif storage == "all":
        elig = np.ones(len(i0), dtype=bool)
    else:
        raise ValueError(f"unknown storage {storage!r}")
    jp = sched.jperp_per_cycle
    jp = np.zeros(len(i0), np.int64) if jp is None else np.asarray(jp)
    out = []
    start = 0
    for k in range(1, len(i0) + 1):
        if (k == len(i0) or i0[k] != i0[start] or elig[k] != elig[start]
                or jp[k] != jp[start]):
            out.append(Plateau(int(i0[start]), k - start, bool(elig[start]), int(jp[start])))
            start = k
    return tuple(out)


def plateau_cycle_schedules(
    plateaus: Sequence[Plateau],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-cycle schedule operands of the plateau-chain kernel K2.

    Flattens a plateau chain into ``(i0_sched (C,), fold_sched (C+1,),
    jperp_sched (C,))`` int32 host arrays: ``i0_sched[c]`` is the I0 of
    cycle c, ``fold_sched[c]`` the storage write-enable of the plateau that
    produced the state current at cycle c — 0 at c = 0 (the chain's
    incoming state belongs to the previous chain), the eligibility of cycle
    c−1's plateau for c ≥ 1, so ``fold_sched[C]`` covers the final state —
    and ``jperp_sched[c]`` the replica coupling of cycle c's update (all 0
    for a classical chain).  One K2 launch over them equals chaining one
    plateau at a time.
    """
    i0s, elig, jps = [], [], []
    for p in plateaus:
        i0s.extend([int(p.i0)] * int(p.length))
        elig.extend([int(bool(p.eligible))] * int(p.length))
        jps.extend([int(p.jperp)] * int(p.length))
    if not i0s:
        raise ValueError("empty plateau chain")
    return (np.asarray(i0s, np.int32), np.asarray([0] + elig, np.int32),
            np.asarray(jps, np.int32))


def tile_plateaus(plateaus: Sequence[Plateau], total_cycles: int) -> Tuple[Plateau, ...]:
    """Tile an iteration's plateau list to exactly ``total_cycles`` cycles,
    truncating the final plateau (cycle-count duration, paper Fig. 12)."""
    if not plateaus and total_cycles > 0:
        raise ValueError("cannot tile an empty plateau sequence")
    out = []
    remaining = int(total_cycles)
    while remaining > 0:
        for p in plateaus:
            if remaining <= 0:
                break
            take = min(p.length, remaining)
            out.append(Plateau(p.i0, take, p.eligible, p.jperp))
            remaining -= take
    return tuple(out)


# ---------------------------------------------------------------------------
# Engine state and the shared one-plateau loop
# ---------------------------------------------------------------------------
class EngineState(NamedTuple):
    """State carried between plateaus; spins are int8 ±1.  The noise state
    is the (4, T, N) int32 xorshift lanes, or the threefry key (a pair of
    Python ints, kept on the host)."""

    noise_state: Any           # (4, T, N) int32 lanes | (k0, k1) key
    m: torch.Tensor            # (T, N) int8 spins
    itanh: torch.Tensor        # (T, N) int32 Itanh state
    best_H: torch.Tensor       # (T,) int32 running best energy
    best_m: torch.Tensor       # (T, N) int8 spins of the running best


class PackedEngineState(NamedTuple):
    """EngineState with spins stored as 32-bit words (1 bit per spin)."""

    noise_state: Any              # (4, T, N) int32 lanes | (k0, k1) key
    m_packed: torch.Tensor        # (T, ceil(N/32)) int32 words
    itanh: torch.Tensor           # (T, N) int32
    best_H: torch.Tensor          # (T,) int32
    best_m_packed: torch.Tensor   # (T, ceil(N/32)) int32 words


def pack_state(state: EngineState) -> PackedEngineState:
    """Pack an engine state's spin planes (exact: spins are ±1)."""
    return PackedEngineState(
        state.noise_state, pack_spins(state.m), state.itanh, state.best_H,
        pack_spins(state.best_m),
    )


def unpack_state(state: PackedEngineState, n: int) -> EngineState:
    """Inverse of :func:`pack_state` for an N-spin model."""
    return EngineState(
        state.noise_state, unpack_spins(state.m_packed, n), state.itanh,
        state.best_H, unpack_spins(state.best_m_packed, n),
    )


def run_plateau_scan(
    field_fn: Callable[[torch.Tensor], torch.Tensor],
    noise_step: Callable,
    h: torch.Tensor,
    n_rnd: int,
    state: EngineState,
    i0: int,
    *,
    length: int,
    eligible: bool,
    track_energy: bool = False,
    emit: bool = False,
    jperp: int = 0,
    n_replicas: int = 0,
    energy_fn: Optional[Callable] = None,
):
    """One constant-I0 plateau as a loop over cycles — one contraction each.

    The field computed for the update of m(t) doubles as the field of
    H(m(t)); cycle 0 skips best-tracking because m(t0) belongs to the
    previous plateau, and one epilogue field evaluation folds the final
    state — the resident kernel's semantics.

    With ``jperp`` ≠ 0 and ``n_replicas`` > 0 (SSQA) the update field gains
    ``jperp · replica_coupling(m, n_replicas)``; the best fold and the
    traces keep the base field.

    ``energy_fn(m, field, h)`` replaces :func:`energy_from_field`: the
    spin-sharded backends sum the per-shard partial energies over the ranks
    before the floor division.

    Returns (state', trace, planes): trace is (mean_H (C,) f32, min_H (C,)
    int32) aligned to the produced states m(t0+1..t0+C) when
    ``track_energy``; planes is the (C, T, ceil(N/32)) packed trajectory
    when ``emit``.
    """
    # i0 is the plateau's scalar I0, or a (T, 1) tensor of per-trial I0s
    # (PT-SSA's replica ladder), broadcast by the Eq. 2b clamp.
    i0 = i0 if isinstance(i0, torch.Tensor) else int(i0)
    jperp = int(jperp)
    need_H = bool(eligible) or bool(track_energy)
    couple = bool(jperp) and int(n_replicas) > 0
    energy_fn = energy_from_field if energy_fn is None else energy_fn
    ns, m, itanh, best_H, best_m = state
    means, mins, planes = [], [], []

    def fold(m, field, best_H, best_m):
        H = energy_fn(m, field, h)
        if eligible:
            better = H < best_H
            best_H = torch.where(better, H, best_H)
            best_m = torch.where(better[..., None], m, best_m)
        if track_energy:
            # jnp.mean as XLA computes it: the (exact) sum times float32 1/T.
            means.append(H.to(torch.float32).sum() * torch.tensor(1.0 / H.numel(),
                                                                   dtype=torch.float32))
            mins.append(H.min())
        return best_H, best_m

    for c in range(int(length)):
        field = field_fn(m)
        if need_H and c >= 1:
            best_H, best_m = fold(m, field, best_H, best_m)
        ns, r = noise_step(ns)
        if couple:
            field = field + jperp * replica_coupling(m, n_replicas)
        m, itanh = ssa_cycle_update(field, itanh, r, i0, n_rnd)
        if emit:
            planes.append(pack_spins(m))
    if need_H:
        # Epilogue: the plateau's final state needs one extra field.
        best_H, best_m = fold(m, field_fn(m), best_H, best_m)
    trace = (torch.stack(means), torch.stack(mins)) if track_energy else None
    return (
        EngineState(ns, m, itanh, best_H, best_m),
        trace,
        torch.stack(planes) if emit else None,
    )


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------
class PlateauBackend:
    """The execution protocol: init_state / run_plateau / run_plateaus /
    finalize.  Subclasses provide the field contraction ``_field`` and may
    override the plateau execution, as :class:`CudaBackend` does."""

    name = "abstract"

    def __init__(
        self,
        model: IsingModel,
        *,
        n_trials: int,
        n_rnd: int = 2,
        noise: str = "threefry",
        storage_layout: str = "dense",
        n_replicas: int = 0,
        device=None,
    ):
        if storage_layout not in ("dense", "packed"):
            raise ValueError(f"unknown storage_layout {storage_layout!r}")
        self.model = model
        self.n_trials = int(n_trials)
        self.n_rnd = int(n_rnd)
        self.noise = noise
        self.storage_layout = storage_layout
        self.n_replicas = int(n_replicas)
        if self.n_replicas:
            if self.n_replicas < 2:
                raise ValueError("n_replicas must be >= 2 (or 0 to disable)")
            if self.n_trials % self.n_replicas:
                raise ValueError(f"n_trials {self.n_trials} not divisible by "
                                 f"n_replicas {self.n_replicas}")
        self.device = resolve_device(device)
        self.h = torch.as_tensor(model.h, dtype=torch.int32, device=self.device)
        lanes = (self.n_trials, model.n)
        if noise == "xorshift":
            self._noise_init = functools.partial(xorshift_init, lanes=lanes,
                                                 device=self.device)
            self._noise_step = xorshift_next_bits
        elif noise == "threefry":
            self._noise_init = threefry_key

            def step(key):
                key, sub = threefry_split(key)
                return key, threefry_noise(sub, lanes, self.device)

            self._noise_step = step
        else:
            raise ValueError(f"unknown noise {noise!r}")

    def init_state(self, seed: int):
        """Random ±1 start from the first noise draw."""
        ns, r0 = self._noise_step(self._noise_init(seed))
        m0 = r0.to(torch.int8)
        itanh0 = torch.where(m0 > 0, 0, -1).to(torch.int32)
        best_H = torch.full(
            (self.n_trials,), BIG_ENERGY, dtype=torch.int32, device=self.device
        )
        st = EngineState(ns, m0, itanh0, best_H, m0)
        return pack_state(st) if self.storage_layout == "packed" else st

    def run_plateau(self, state, i0, *, length: int, eligible: bool,
                    track_energy: bool = False, emit: bool = False, jperp: int = 0):
        """Advance one plateau in this backend's storage layout (the packed
        layout wraps the dense loop in the exact pack/unpack codec).
        ``jperp`` is the plateau's SSQA coupling, applied when the backend
        was built with ``n_replicas``."""
        packed = self.storage_layout == "packed"
        st = unpack_state(state, self.model.n) if packed else state
        st, trace, planes = run_plateau_scan(
            self._field, self._noise_step, self.h, self.n_rnd, st, i0,
            length=length, eligible=eligible, track_energy=track_energy,
            emit=emit, jperp=jperp, n_replicas=self.n_replicas,
        )
        return (pack_state(st) if packed else st), trace, planes

    def run_plateaus(self, state, plateaus: Sequence[Plateau]):
        """Advance a whole plateau chain (record='best', no traces)."""
        for p in plateaus:
            state, _, _ = self.run_plateau(
                state, p.i0, length=p.length, eligible=p.eligible, jperp=p.jperp
            )
        return state

    def finalize(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        """(best_H, best_m int8) after the last plateau."""
        if self.storage_layout == "packed":
            return state.best_H, unpack_spins(state.best_m_packed, self.model.n)
        return state.best_H, state.best_m

    def _field(self, m: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class SparseBackend(PlateauBackend):
    """Padded-adjacency gather field (4/8-regular G-set-class instances)."""

    name = "sparse"

    def __init__(self, model: IsingModel, **kw):
        super().__init__(model, **kw)
        _, self.nbr_idx, self.nbr_w = model.device_arrays(self.device)

    def _field(self, m):
        return local_fields_sparse(m, self.h, self.nbr_idx, self.nbr_w)


def resolve_j_mode(j_mode: str, n: int) -> str:
    """'auto' picks tiled above TILED_J_THRESHOLD spins, dense below."""
    if j_mode == "auto":
        return "tiled" if n > TILED_J_THRESHOLD else "dense"
    if j_mode not in ("dense", "tiled"):
        raise ValueError(f"unknown j_mode {j_mode!r}")
    return j_mode


def model_weight_bits(model: IsingModel) -> int:
    """Magnitude bitplanes a model's couplings need (coalesced max |J_ij|)."""
    return adjacency_weight_bits(model.n, model.nbr_idx, model.nbr_w)


def resolve_field_mode(field_mode: str, j_bits: int) -> str:
    """Field arithmetic: 'popcount' (XNOR-popcount on the coupling
    bitplanes, exact integers) or 'dense' (the (N, N) J).  'auto' takes
    popcount while the couplings fit POPCOUNT_AUTO_MAX_BITS magnitude
    planes: the contraction costs one pass per plane."""
    if field_mode == "auto":
        return "popcount" if int(j_bits) <= POPCOUNT_AUTO_MAX_BITS else "dense"
    if field_mode not in ("dense", "popcount"):
        raise ValueError(f"unknown field_mode {field_mode!r}")
    return field_mode


def _resolve_field_mode(field_mode: str, model: IsingModel) -> str:
    bits = model_weight_bits(model) if field_mode == "auto" else 1
    return resolve_field_mode(field_mode, bits)


def resolve_noise_mode(noise_mode: str, noise: str) -> str:
    """Resident-kernel noise datapath: 'streamed' (in-kernel xorshift, no
    noise buffer, K1) vs 'pregen' (a per-plateau (C, T, N) buffer, K4).
    'auto' streams whenever the source is xorshift; threefry cannot be
    reproduced in-kernel, so it always pregenerates."""
    if noise_mode == "auto":
        return "streamed" if noise == "xorshift" else "pregen"
    if noise_mode not in ("streamed", "pregen"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if noise_mode == "streamed" and noise != "xorshift":
        raise ValueError("noise_mode='streamed' requires noise='xorshift'")
    return noise_mode


def resolve_partition(partition: str, n: int, mesh=None) -> str:
    """The work-partitioning axis of an N-spin plateau program.

    'problem' stacks whole problems on each device; 'spin' shards the spin
    axis of each problem over the ranks of ``mesh``
    (:mod:`repro_torch.core.distributed`).  'auto' picks 'spin' only on a
    mesh of several ranks, at or above SPIN_SHARD_MIN_N spins, and when the
    ranks divide N — otherwise the problem-partitioned path is both simpler
    and faster."""
    if partition not in ("problem", "spin", "auto"):
        raise ValueError(f"unknown partition {partition!r}")
    if partition != "auto":
        return partition
    p = spin_axis_size(mesh)
    if p > 1 and int(n) >= SPIN_SHARD_MIN_N and int(n) % p == 0:
        return "spin"
    return "problem"


def resolve_backend(backend: str, n: int) -> str:
    """'auto' runs the resident CUDA kernels at or above MIN_RESIDENT_N spins
    and the dense backend below it; any other name passes through.  Every
    backend gives the same numbers, so the choice moves time only."""
    if backend == "auto":
        return "cuda" if int(n) >= MIN_RESIDENT_N else "dense"
    return backend


def resolve_j_dtype(j_dtype) -> torch.dtype:
    """The dtype the dense and cuda backends hold J in: float32 for None, a
    64-bit dtype's 32-bit counterpart; a dtype outside J_DTYPES raises
    ValueError naming those they take."""
    dt = torch.float32 if j_dtype is None else _J_32BIT.get(j_dtype, j_dtype)
    if dt not in J_DTYPES:
        raise ValueError(f"j_dtype={j_dtype}: J may be held in "
                         f"{', '.join(str(d) for d in J_DTYPES)}")
    return dt


def _host_j(model: IsingModel, j_dtype: torch.dtype) -> torch.Tensor:
    """The model's (N, N) J on the host in ``j_dtype``: rounded to nearest
    even, or wrapped for a narrow integer dtype.  Outside float32 the
    rounded J is held to the exactness contract the model's own J was
    checked against at construction (every |h_i| + Σ_j |J_ij| below 2^24),
    so the float32 fields stay exact."""
    J = torch.from_numpy(model.dense_J()).to(j_dtype)
    if j_dtype != torch.float32 and J.numel():
        bound = (J.to(torch.float64).abs().sum(-1)
                 + torch.from_numpy(np.abs(np.asarray(model.h, np.float64)))).max()
        if not bound < _F32_EXACT_BOUND:
            raise ValueError(f"model {model.name!r}: the field bound of J in {j_dtype} is "
                             f"{float(bound)}, outside the float32-exact range (< 2^24)")
    return J


def exact_float32_matmul() -> None:
    """Turn TF32 off for CUDA float32 matmuls, so the dense field
    ``h + m @ J`` is exact: TF32 keeps 10 mantissa bits, and fields above
    2^11 would round.

    The setting is process-wide: ``torch.backends.cuda.matmul.allow_tf32``
    is global state, so every float32 matmul of the process runs in full
    float32 from the first call on, and nothing here turns TF32 back on.
    :class:`DenseBackend`, :class:`BatchedDenseBackend` and
    ``serve.AnnealService`` call it; it writes the flag only while it is on.
    """
    if torch.backends.cuda.matmul.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False


class DenseBackend(PlateauBackend):
    """(T, N)·(N, N) float32 matmul field (K2000-class dense instances).

    The product is ``torch.matmul``, as the JAX package leaves it to XLA;
    it is exact with TF32 off (:func:`exact_float32_matmul`).

    ``j_dtype`` (float32 by default; any of J_DTYPES) is the dtype
    the held J is rounded into and kept in; the product is float32 m @
    float32(J), as the JAX package's promotion makes it.

    ``j_mode`` sets where J lives: 'dense' holds the (N, N) J;
    'tiled' holds none and streams (tile_n, N) slabs scattered from the
    padded adjacency (:func:`~repro_torch.core.ising.local_fields_tiled`),
    bit-identical, which is what admits G77/G81-class N; 'auto' tiles above
    TILED_J_THRESHOLD spins.

    ``field_mode='popcount'`` (or 'auto' within POPCOUNT_AUTO_MAX_BITS
    planes) packs the couplings as bitplanes and takes the field from
    :func:`~repro_torch.core.ising.local_fields_popcount`, row-tiled at
    ``tile_n`` above TILED_J_THRESHOLD spins; no J exists then, dense or
    tiled, and any noise is accepted.  Tiled and popcount fields ignore
    ``j_dtype``, as in the JAX package.  ``double_buffer`` builds each
    tiled slab before contracting the one before it (the same numbers).
    """

    name = "dense"

    def __init__(self, model: IsingModel, *, j_mode: str = "auto", tile_n: int = POPCOUNT_TILE_N,
                 field_mode: str = "dense", j_dtype=None, double_buffer: bool = False, **kw):
        super().__init__(model, **kw)
        self.j_mode = resolve_j_mode(j_mode, model.n)
        self.tile_n = int(tile_n)
        self.double_buffer = bool(double_buffer)
        self.field_mode = _resolve_field_mode(field_mode, model)
        if self.field_mode == "popcount":
            self.packed_j = pack_couplings_from_adjacency(
                model.n, model.nbr_idx, model.nbr_w, device=self.device)
            self._pc_tile = None if model.n <= TILED_J_THRESHOLD else self.tile_n
            return
        exact_float32_matmul()
        if self.j_mode == "tiled":
            _, self.nbr_idx, self.nbr_w = model.device_arrays(self.device)
        else:
            self.J = _host_j(model, resolve_j_dtype(j_dtype)).to(self.device)

    def _field(self, m):
        if self.field_mode == "popcount":
            return local_fields_popcount(pack_spins(m), self.h, self.packed_j,
                                         tile_n=self._pc_tile)
        if self.j_mode == "tiled":
            return local_fields_tiled(m, self.h, self.nbr_idx, self.nbr_w, tile_n=self.tile_n,
                                      double_buffer=self.double_buffer)
        return local_fields_dense(m, self.h, self.J)


def _lead(st):
    """A single problem's state as a B = 1 batch (None leaves stay None)."""
    return _map_tree(lambda a: None if a is None else a[None], st)


def _first(st):
    """The one problem of a B = 1 batched state."""
    return _map_tree(lambda a: None if a is None else a[0], st)


class _CudaDispatch:
    """The kernels' dispatch, over a leading problem axis: one launch of
    K1, K4 or K2 per call, for every problem of the batch.
    :class:`BatchedCudaBackend` calls it at B, :class:`CudaBackend` at B =
    1 (its arrays viewed with a size-1 axis in front).  Needs ``n_rnd``,
    ``n_replicas``, ``device`` and a ``_schedules`` dict."""

    def _k1(self, problem: dict, st: PackedEngineState, p: Plateau) -> PackedEngineState:
        """K1 over one plateau.  Ring mode only where the plateau couples:
        J⊥ = 0 runs the classical kernel, as the JAX package's pallas
        backends do."""
        mp, it, rng, bh, bmp = kssa.ssa_plateau_packed_batched(
            st.m_packed, st.itanh, problem["J"], problem["h"], st.noise_state, p.i0,
            st.best_H, st.best_m_packed, n_cycles=p.length, n_rnd=self.n_rnd,
            eligible=p.eligible, jperp=p.jperp,
            n_replicas=self.n_replicas if p.jperp else 0,
        )
        return PackedEngineState(rng, mp, it, bh, bmp)

    def _k4(self, problem: dict, st: EngineState, noise: torch.Tensor,
            p: Plateau) -> EngineState:
        """K4 over one plateau's pregenerated (B, C, T, N) noise; the noise
        state, which drew it, passes through."""
        m, it, bh, bm = kssa.ssa_plateau_batched(
            st.m.to(torch.float32), st.itanh, problem["J"], problem["h"], noise, p.i0,
            st.best_H, st.best_m, n_rnd=self.n_rnd, eligible=p.eligible,
        )
        return st._replace(m=m.to(torch.int8), itanh=it, best_H=bh, best_m=bm)

    def _k2(self, problem: dict, st: PackedEngineState, plateaus) -> PackedEngineState:
        """K2 over a whole plateau chain, in ring mode where the chain's J⊥
        is not all 0."""
        i0_sched, fold_sched, jperp_sched = self._device_schedules(plateaus)
        mp, it, rng, bh, bmp = kssa.ssa_plateau_popcount_batched(
            st.m_packed, st.itanh, problem["sign"], problem["mags"], problem["base"],
            problem["h"], st.noise_state, i0_sched, fold_sched, st.best_H, st.best_m_packed,
            n_rnd=self.n_rnd, jperp_sched=jperp_sched, n_replicas=self.n_replicas,
        )
        return PackedEngineState(rng, mp, it, bh, bmp)

    def _device_schedules(self, plateaus: Tuple[Plateau, ...]):
        """(i0_sched, fold_sched, jperp_sched or None) of a chain on the
        device: built on the host and copied in one transfer, once per
        distinct chain; ``jperp_sched`` is None for a chain without
        coupling."""
        sched = self._schedules.get(plateaus)
        if sched is None:
            i0_sched, fold_sched, jperp_sched = plateau_cycle_schedules(plateaus)
            flat = torch.from_numpy(np.concatenate([i0_sched, fold_sched, jperp_sched]))
            flat = flat.to(self.device)
            C = len(i0_sched)
            sched = self._schedules[plateaus] = (
                flat[:C], flat[C:2 * C + 1], flat[2 * C + 1:] if jperp_sched.any() else None)
        return sched


class CudaBackend(_CudaDispatch, PlateauBackend):
    """The resident CUDA plateau kernels: one launch per plateau.

    Counterpart of the JAX package's ``PallasBackend``.  With the dense
    field, a plateau without per-cycle outputs runs one kernel:

    * ``noise_mode='streamed'`` (xorshift's default): K1
      (:func:`~repro_torch.kernels.ssa_update.ssa_plateau_packed_batched`
      at B = 1, through :class:`_CudaDispatch`) — spins cross the launch
      boundary as 32-bit words and the noise lanes are stepped inside the
      kernel, so no (C, T, N) noise buffer exists.  An SSQA plateau (a
      backend with ``n_replicas``, the plateau's J⊥ ≠ 0) runs K1's ring
      mode; a plateau with J⊥ = 0, such as the first of every SSQA
      schedule, runs the classical K1;
    * ``noise_mode='pregen'`` (threefry's only datapath; opt-in for
      xorshift, bit-identical to streamed): K4
      (:func:`~repro_torch.kernels.ssa_update.ssa_plateau_batched` at B =
      1) over the plateau's (C, T, N) int8 noise, drawn before the
      launch.  K4 has no ring mode, in the JAX package either: an SSQA
      plateau with J⊥ ≠ 0 runs the cycle loop over K3.

    Plateaus that need per-cycle outputs (``track_energy``, trajectory
    planes) run the cycle loop with the field from K3
    (:func:`~repro_torch.kernels.ops.local_field`).

    ``j_dtype`` (float32 by default; any of J_DTYPES) is the dtype J is
    rounded or wrapped into and held in; K1, K1's ring mode, K3 and K4 read
    it as it is.

    ``field_mode='popcount'`` (or 'auto' within POPCOUNT_AUTO_MAX_BITS
    planes) holds the couplings as ``PackedJ`` bitplanes and no J, and runs
    K2 (:func:`~repro_torch.kernels.ssa_update.ssa_plateau_popcount_batched`
    at B = 1): :meth:`run_plateaus` makes one launch per plateau chain, with the
    per-cycle I0, fold and J⊥ schedules built on the host and copied to the
    device once per distinct chain; a chain whose J⊥ schedule is not all 0
    runs K2's ring mode.  K2 steps xorshift lanes in-kernel, so popcount
    requires ``noise_mode='streamed'``, as the JAX package's
    ``PallasBackend`` does; the cycle loop of per-cycle outputs takes the
    plain popcount field.

    On CPU tensors (``device='cpu'``) the wrappers run their plain
    versions — the path the CPU tests hold against the JAX package.
    """

    name = "cuda"

    def __init__(self, model: IsingModel, *, noise_mode: str = "auto",
                 field_mode: str = "dense", j_dtype=None, **kw):
        super().__init__(model, **kw)
        self.noise_mode = resolve_noise_mode(noise_mode, self.noise)
        self.field_mode = _resolve_field_mode(field_mode, model)
        self._schedules = {}
        if self.field_mode == "popcount":
            if self.noise_mode != "streamed":
                raise ValueError(
                    "field_mode='popcount' on the cuda backend requires "
                    "noise_mode='streamed' (noise='xorshift'): the plateau-chain "
                    "kernel K2 generates its noise in-kernel"
                )
            # In K2's plane layout once, so no launch copies the planes.
            self.packed_j = kssa.popcount_planes(pack_couplings_from_adjacency(
                model.n, model.nbr_idx, model.nbr_w, device=self.device))
            pj = self.packed_j
            self._problem = {"sign": pj.sign[None], "mags": pj.mags[None],
                             "base": pj.base[None], "h": self.h[None]}
        else:
            self.J = _host_j(model, resolve_j_dtype(j_dtype)).to(self.device)
            self._problem = {"J": self.J[None], "h": self.h[None]}

    def _field(self, m):
        if self.field_mode == "popcount":
            return local_fields_popcount(pack_spins(m), self.h, self.packed_j)
        return kops.local_field(m, self.h, self.J)

    def _packed_launch(self, state, launch):
        """``launch`` of the packed B = 1 state, in either storage layout."""
        packed = self.storage_layout == "packed"
        out = _first(launch(_lead(state if packed else pack_state(state))))
        return out if packed else unpack_state(out, self.model.n)

    def run_plateaus(self, state, plateaus: Sequence[Plateau]):
        """Under popcount, the whole chain is one K2 launch; otherwise one
        launch per plateau."""
        if self.field_mode != "popcount" or not plateaus:
            return super().run_plateaus(state, plateaus)
        return self._packed_launch(
            state, lambda st: self._k2(self._problem, st, tuple(plateaus)))

    def _pregen_noise(self, ns, length: int):
        """The plateau's (C, T, N) int8 noise and the noise state after it:
        the same draws, in the same order, as C cycles of the loop."""
        if self.noise == "threefry":
            return threefry_noise_cycles(ns, length, (self.n_trials, self.model.n),
                                         self.device)
        return xorshift_noise_cycles(ns, length)

    def run_plateau(self, state, i0, *, length: int, eligible: bool,
                    track_energy: bool = False, emit: bool = False, jperp: int = 0):
        jperp = int(jperp)
        # K4 has no ring mode: SSQA plateaus on the pregen datapath take the
        # cycle loop over K3, as the JAX package's pregen path takes its scan.
        if emit or track_energy or (jperp and self.noise_mode != "streamed"):
            return super().run_plateau(
                state, i0, length=length, eligible=eligible,
                track_energy=track_energy, emit=emit, jperp=jperp,
            )
        p = Plateau(int(i0), int(length), bool(eligible), jperp)
        if self.field_mode == "popcount":
            # One plateau is a chain of constant I0: fold [0] + [eligible]*C.
            st = self._packed_launch(state, lambda st: self._k2(self._problem, st, (p,)))
        elif self.noise_mode == "pregen":
            packed = self.storage_layout == "packed"
            st = unpack_state(state, self.model.n) if packed else state
            ns, noise = self._pregen_noise(st.noise_state, length)
            st = _first(self._k4(self._problem, _lead(st._replace(noise_state=None)),
                                 noise[None], p))._replace(noise_state=ns)
            st = pack_state(st) if packed else st
        else:
            st = self._packed_launch(state, lambda st: self._k1(self._problem, st, p))
        return st, None, None


BACKENDS = {
    "sparse": SparseBackend,
    "dense": DenseBackend,
    "cuda": CudaBackend,
}


def make_backend(
    backend: Optional[str] = None,
    model: IsingModel = None,
    *,
    n_trials: int,
    n_rnd: int = 2,
    noise: Optional[str] = None,
    partition: Optional[str] = None,
    mesh=None,
    device=None,
    config: Optional[SolverConfig] = None,
    **opts,
) -> PlateauBackend:
    """Build the named backend, optionally from ``config=SolverConfig(...)``,
    whose engine options are merged under ``opts``.  ``partition='spin'``
    (or 'auto' on a mesh of several ranks) builds the spin-sharded backend
    over ``mesh`` (:class:`~repro_torch.core.distributed.SpinShardedBackend`),
    with ``backend`` as the field arithmetic each shard runs.
    ``backend='auto'`` resolves over the model's spins
    (:func:`resolve_backend`)."""
    if config is not None:
        backend = config.backend if backend is None else backend
        noise = config.noise if noise is None else noise
        partition = config.partition if partition is None else partition
        mesh = config.mesh if mesh is None else mesh
        opts = {**config.engine_opts(), **opts}
    backend = "sparse" if backend is None else backend
    noise = "threefry" if noise is None else noise
    if resolve_partition(partition or "problem", model.n, mesh) == "spin":
        from .distributed import SpinShardedBackend  # distributed imports this module

        return SpinShardedBackend(model, n_trials=n_trials, n_rnd=n_rnd, noise=noise,
                                  mesh=mesh, base_backend=backend, device=device, **opts)
    backend = resolve_backend(backend, model.n)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {sorted(BACKENDS)}")
    return BACKENDS[backend](model, n_trials=n_trials, n_rnd=n_rnd, noise=noise,
                             device=device, **opts)


# ---------------------------------------------------------------------------
# The backend-agnostic schedule runner
# ---------------------------------------------------------------------------
def run_schedule(
    backend: PlateauBackend,
    plateaus: Sequence[Plateau],
    state,
    *,
    record: str = "best",
    track_energy: bool = False,
):
    """Chain ``run_plateau`` over a plateau sequence.

    record='best': eligible plateaus fold their states into the running
    arg-best.  record='traj': eligible plateaus emit packed spin planes
    instead, and the caller finds the best among them.

    Returns (state, trace, planes): trace = (mean_H, min_H) over all cycles
    when track_energy, planes concatenated over eligible plateaus when
    record='traj'.
    """
    if record == "best" and not track_energy:
        return backend.run_plateaus(state, tuple(plateaus)), None, None
    tr_mean, tr_min, planes = [], [], []
    for p in plateaus:
        if record == "traj":
            state, _, pl = backend.run_plateau(
                state, p.i0, length=p.length, eligible=False, emit=p.eligible,
                jperp=p.jperp,
            )
            if pl is not None:
                planes.append(pl)
        elif record == "best":
            state, tr, _ = backend.run_plateau(
                state, p.i0, length=p.length, eligible=p.eligible,
                track_energy=track_energy, jperp=p.jperp,
            )
            if tr is not None:
                tr_mean.append(tr[0])
                tr_min.append(tr[1])
        else:
            raise ValueError(f"unknown record {record!r}")
    trace = (torch.cat(tr_mean), torch.cat(tr_min)) if tr_mean else None
    planes_out = torch.cat(planes, dim=0) if planes else None
    return state, trace, planes_out


# ---------------------------------------------------------------------------
# Shape buckets and padded problems (the serving substrate)
# ---------------------------------------------------------------------------
def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def bucket_n(n: int, min_bucket: int = 64) -> int:
    """The serving shape bucket of an N-spin problem: a power-of-two width,
    so a heterogeneous request stream shares a few programs."""
    if n <= 0:
        raise ValueError(f"need n > 0, got {n}")
    return max(next_pow2(int(min_bucket)), next_pow2(n))


def pad_model(model: IsingModel, n_bucket: int) -> IsingModel:
    """Zero-pad an Ising model to ``n_bucket`` spins.

    Pad rows carry h = 0 and self-index, zero-weight adjacency, so their
    field is 0 in every field mode and they add nothing to H: the live
    lanes of a padded run evolve as in the unpadded run, given the
    padding-invariant noise of :func:`padded_noise_init`.
    """
    if model.n == n_bucket:
        return model
    if model.n > n_bucket:
        raise ValueError(f"model has {model.n} spins > bucket {n_bucket}")
    pad = n_bucket - model.n
    d = model.max_degree
    h = np.concatenate([np.asarray(model.h, np.int32), np.zeros(pad, np.int32)])
    idx = np.concatenate([
        np.asarray(model.nbr_idx, np.int32),
        np.tile(np.arange(model.n, n_bucket, dtype=np.int32)[:, None], (1, d)),
    ], axis=0)
    w = np.concatenate([np.asarray(model.nbr_w, np.int32), np.zeros((pad, d), np.int32)],
                       axis=0)
    return IsingModel(n=n_bucket, h=h, nbr_idx=idx, nbr_w=w,
                      name=f"{model.name}@pad{n_bucket}")


def padded_noise_init(noise: str, seed: int, n_trials: int, n_live: int, n_bucket: int,
                      device=None):
    """A noise state over (n_trials, n_bucket) lanes whose live lanes are
    padding-invariant.

    For xorshift the live lanes [0, n_live) are seeded exactly as the
    unpadded ``xorshift_init(seed, (n_trials, n_live))`` seeds them, and the
    pad lanes from the stream seeded ``seed ^ 0x9E3779B9``: lanes never
    interact, so a bucket-padded run equals the unpadded run on its live
    lanes.  Threefry draws depend on the shape, so threefry stays a key
    (``threefry_key(seed)``) and its padded runs are valid but not
    bit-comparable to unpadded ones, as in the JAX package.
    """
    if noise == "xorshift":
        live = xorshift_init(seed, (n_trials, n_live), device)
        if n_bucket == n_live:
            return live
        pad = xorshift_init(seed ^ 0x9E3779B9, (n_trials, n_bucket - n_live), device)
        return torch.cat([live, pad], dim=-1)
    if noise == "threefry":
        return threefry_key(seed)
    raise ValueError(f"unknown noise {noise!r}")


def padded_noise_init_slice(seed: int, n_trials: int, n_live: int, n_bucket: int,
                            lo: int, hi: int) -> np.ndarray:
    """Columns [lo, hi) of ``padded_noise_init('xorshift', ...)``, seeded
    alone, as a numpy (4, n_trials, hi - lo) uint32 block: the live columns
    from the unpadded (n_trials, n_live) lane grid, the pad columns from the
    stream seeded ``seed ^ 0x9E3779B9``, each through
    :func:`~repro_torch.core.rng.xorshift_init_slice`.  Each rank of a
    spin-sharded run seeds only its own columns, and the result equals the
    single-device stream."""
    lo, hi = int(lo), int(hi)
    n_live, n_bucket = int(n_live), int(n_bucket)
    if not 0 <= lo <= hi <= n_bucket:
        raise ValueError(f"slice [{lo}, {hi}) outside [0, {n_bucket})")
    parts = []
    if lo < n_live:
        parts.append(xorshift_init_slice(seed, (n_trials, n_live), lo, min(hi, n_live)))
    if hi > n_live:
        parts.append(xorshift_init_slice(seed ^ 0x9E3779B9, (n_trials, n_bucket - n_live),
                                         max(lo, n_live) - n_live, hi - n_live))
    if not parts:
        return np.zeros((4, int(n_trials), 0), np.uint32)
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=-1)


def pad_degree(model: IsingModel, d: int) -> IsingModel:
    """Pad a model's adjacency to ``d`` neighbour columns with self-index,
    zero-weight entries: the field is unchanged, as under bucket padding.
    Stacked adjacency needs one width for the whole batch."""
    d = int(d)
    if model.max_degree == d:
        return model
    if model.max_degree > d:
        raise ValueError(f"model degree {model.max_degree} exceeds target degree {d}")
    extra = d - model.max_degree
    self_idx = np.tile(np.arange(model.n, dtype=np.int32)[:, None], (1, extra))
    return IsingModel(
        n=model.n, h=np.asarray(model.h, np.int32),
        nbr_idx=np.concatenate([np.asarray(model.nbr_idx), self_idx], axis=1),
        nbr_w=np.concatenate([np.asarray(model.nbr_w), np.zeros((model.n, extra), np.int32)],
                             axis=1),
        name=model.name,
    )


# ---------------------------------------------------------------------------
# Batched backends: B stacked, bucket-padded problems per launch
# ---------------------------------------------------------------------------
def _map_tree(fn, tree, *rest):
    """``fn`` over the tensor and array leaves of nested dicts, named
    tuples, tuples and lists (a batched state, a stacked problem)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def extract_slot(tree, slot: int):
    """One problem lane of a batched state or stacked problem, keeping a
    size-1 problem axis, so it compares with (and splices into) a B = 1
    batch of the same request."""
    return _map_tree(lambda a: a[slot:slot + 1], tree)


def splice_slot(tree, slot: int, sub):
    """A copy of ``tree`` with lane ``slot`` replaced by the size-1 lane
    ``sub``.  Lanes never interact, so every other lane's trajectory is
    unchanged."""
    def put(a, s):
        out = a.clone() if isinstance(a, torch.Tensor) else np.array(a, copy=True)
        out[slot] = s[0]
        return out

    return _map_tree(put, tree, sub)


def _stack_sparse_models(models, n_bucket: int, device) -> dict:
    """Stacked, bucket- and degree-padded adjacency {h, nbr_idx, nbr_w}."""
    padded = [pad_model(m, n_bucket) for m in models]
    d = max(m.max_degree for m in padded)
    padded = [pad_degree(m, d) for m in padded]
    return {k: torch.as_tensor(np.stack([np.asarray(getattr(m, k)) for m in padded]),
                               dtype=torch.int32, device=device)
            for k in ("h", "nbr_idx", "nbr_w")}


def _stack_dense_models(models, n_bucket: int, device, j_dtype=torch.float32) -> dict:
    """Stacked, bucket-padded dense views {h (B, N), J (B, N, N) j_dtype}."""
    J = torch.zeros((len(models), n_bucket, n_bucket), dtype=j_dtype, device=device)
    h = torch.zeros((len(models), n_bucket), dtype=torch.int32, device=device)
    for b, m in enumerate(models):
        J[b, :m.n, :m.n] = _host_j(m, j_dtype).to(device)
        h[b, :m.n] = torch.as_tensor(np.asarray(m.h), dtype=torch.int32, device=device)
    return {"h": h, "J": J}


def _stack_packed_models(models, n_bucket: int, j_bits: int, device) -> dict:
    """Stacked, bucket-padded coupling bitplanes {h, sign, mags, base}.

    Every model packs to ``j_bits`` magnitude planes, the group's maximum,
    so the stacked ``mags`` has one shape; pad rows have no couplings, so
    their planes and base are 0.
    """
    hs, pjs = [], []
    for m in models:
        p = pad_model(m, n_bucket)
        pjs.append(pack_couplings_from_adjacency(p.n, p.nbr_idx, p.nbr_w, n_bits=j_bits,
                                                 device=device))
        hs.append(torch.as_tensor(p.h, dtype=torch.int32, device=device))
    return {"h": torch.stack(hs), **{k: torch.stack([getattr(pj, k) for pj in pjs])
                                     for k in ("sign", "mags", "base")}}


def _local_fields_sparse_batched(m, h, nbr_idx, nbr_w):
    """:func:`local_fields_sparse` per problem: spins (B, T, N) against
    stacked adjacency (B, N, D), h (B, 1, N)."""
    B, T, N = m.shape
    flat = nbr_idx.to(torch.int64).reshape(B, 1, -1).expand(B, T, -1)
    neigh = torch.gather(m.to(torch.int32), 2, flat).reshape(B, T, N, -1)
    return h + (nbr_w[:, None] * neigh).sum(dim=-1, dtype=torch.int32)


class BatchedBackend:
    """B stacked, bucket-padded problems advanced together.

    The serving counterpart of :class:`PlateauBackend`: the problem arrays
    are call-time arguments (the dict :meth:`stack` returns), not
    constructor state, so one backend per (backend, options, N_bucket, B,
    n_trials, schedule) serves every request group of that shape — the
    service's program cache keys on exactly those.

    The state is :class:`EngineState` (or :class:`PackedEngineState`) with a
    leading problem axis: spins (B, T, N), best_H (B, T), xorshift lanes
    (B, 4, T, N); threefry keys are a (B, 2) int64 host array, one key per
    problem, each stepped on its own.  The sparse and dense backends run
    the cycle loop of :func:`run_plateau_scan` once for all B problems, the
    problem axis leading every tensor; :class:`BatchedCudaBackend` makes one
    kernel launch per plateau (or chain) for all B.  Every backend is
    bit-identical per problem to the single-problem one.
    """

    name = "abstract"

    def __init__(self, *, n_bucket: int, n_trials: int, n_rnd: int = 2,
                 noise: str = "xorshift", storage_layout: str = "dense",
                 n_replicas: int = 0, device=None):
        if storage_layout not in ("dense", "packed"):
            raise ValueError(f"unknown storage_layout {storage_layout!r}")
        if noise not in ("xorshift", "threefry"):
            raise ValueError(f"unknown noise {noise!r}")
        self.n_bucket = int(n_bucket)
        self.n_trials = int(n_trials)
        self.n_rnd = int(n_rnd)
        self.noise = noise
        self.storage_layout = storage_layout
        self.n_replicas = int(n_replicas)
        if self.n_replicas:
            if self.n_replicas < 2:
                raise ValueError(f"n_replicas must be >= 2, got {self.n_replicas}")
            if self.n_trials % self.n_replicas:
                raise ValueError(f"n_trials={self.n_trials} not divisible by "
                                 f"n_replicas={self.n_replicas}")
        self.device = resolve_device(device)

    # -- noise ------------------------------------------------------------
    def _noise_step(self, ns):
        """One draw for every problem: (state', (B, T, N) int32 ±1)."""
        if self.noise == "xorshift":
            st, r = xorshift_next_bits(ns.transpose(0, 1))
            return st.transpose(0, 1), r
        keys, draws = [], []
        for key in ns.tolist():
            key, sub = threefry_split(tuple(key))
            keys.append(key)
            draws.append(threefry_noise(sub, (self.n_trials, self.n_bucket), self.device))
        return np.asarray(keys, np.int64), torch.stack(draws)

    def _noise_cycles(self, ns, length: int):
        """``length`` draws for every problem at once: (state', (B, C, T, N)
        int8 ±1), the same draws as ``length`` steps."""
        if self.noise == "xorshift":
            st, noise = xorshift_noise_cycles(ns.transpose(0, 1), length)
            return st.transpose(0, 1).contiguous(), noise.transpose(0, 1).contiguous()
        keys, draws = [], []
        for key in ns.tolist():
            key, noise = threefry_noise_cycles(tuple(key), length,
                                               (self.n_trials, self.n_bucket), self.device)
            keys.append(key)
            draws.append(noise)
        return np.asarray(keys, np.int64), torch.stack(draws)

    # -- host side --------------------------------------------------------
    def stack(self, models: Sequence[IsingModel]) -> dict:
        """Pad each model to the bucket and stack its arrays on axis 0."""
        raise NotImplementedError

    def init_noise(self, seeds: Sequence[int], n_lives: Sequence[int]):
        """Stacked per-problem noise states (padding-invariant live lanes)."""
        if self.noise == "threefry":
            return np.asarray([threefry_key(int(s)) for s in seeds], np.int64).reshape(-1, 2)
        return torch.stack([
            padded_noise_init("xorshift", int(s), self.n_trials, int(nl), self.n_bucket,
                              self.device)
            for s, nl in zip(seeds, n_lives)
        ])

    # -- device side ------------------------------------------------------
    def init_state(self, problem: dict, noise0):
        """Random ±1 start from the first noise draw (as PlateauBackend)."""
        ns, r0 = self._noise_step(noise0)
        if isinstance(ns, torch.Tensor):
            ns = ns.contiguous()
        m0 = r0.to(torch.int8)
        itanh0 = torch.where(m0 > 0, 0, -1).to(torch.int32)
        best_H = torch.full(m0.shape[:-1], BIG_ENERGY, dtype=torch.int32, device=self.device)
        st = EngineState(ns, m0, itanh0, best_H, m0)
        return pack_state(st) if self.storage_layout == "packed" else st

    def run_plateau(self, problem: dict, state, i0, *, length: int, eligible: bool,
                    jperp: int = 0):
        """Advance one plateau, in this backend's storage layout."""
        plateau = Plateau(int(i0), int(length), bool(eligible), int(jperp))
        return self.run_shots(problem, state, (plateau,), 1)

    def run_shots(self, problem: dict, state, plateaus: Sequence[Plateau], n_shots: int):
        """Advance ``n_shots`` whole iterations (plateau chains): one
        service chunk.  Under 'packed' the state entering and leaving —
        what is kept between chunks — carries its spins as 32-bit words."""
        packed = self.storage_layout == "packed"
        st = unpack_state(state, self.n_bucket) if packed else state
        for _ in range(int(n_shots)):
            for p in plateaus:
                st = self._plateau(problem, st, p)
        return pack_state(st) if packed else st

    def _plateau(self, problem: dict, st: EngineState, p: Plateau) -> EngineState:
        st, _, _ = run_plateau_scan(
            functools.partial(self._field, problem), self._noise_step, problem["h"][:, None],
            self.n_rnd, st, p.i0, length=p.length, eligible=p.eligible, jperp=p.jperp,
            n_replicas=self.n_replicas,
        )
        return st

    def _field(self, problem: dict, m: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def finalize(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        """(best_H (B, T), best_m (B, T, N) int8) of a batched state."""
        if self.storage_layout == "packed":
            return state.best_H, unpack_spins(state.best_m_packed, self.n_bucket)
        return state.best_H, state.best_m

    # -- checkpoints ------------------------------------------------------
    # A checkpoint holds whole arrays.  The spin-sharded backend gathers its
    # shards here, lets one rank write and synchronises the ranks after it.
    writes_checkpoints = True

    def checkpoint_state(self, state):
        """The tree a checkpoint of ``state`` holds."""
        return state

    def restore_state(self, tree):
        """This backend's state from a restored checkpoint tree."""
        return tree

    def sync(self) -> None:
        """Wait for every rank (a no-op on one device)."""

    def rank_span(self, value: int) -> Tuple[int, int]:
        """(min, max) of ``value`` over the ranks (one device: (value, value))."""
        return value, value


class BatchedSparseBackend(BatchedBackend):
    """Padded-adjacency gather field, for all problems at once."""

    name = "sparse"

    def stack(self, models):
        return _stack_sparse_models(models, self.n_bucket, self.device)

    def _field(self, problem, m):
        return _local_fields_sparse_batched(m, problem["h"][:, None], problem["nbr_idx"],
                                            problem["nbr_w"])


class BatchedDenseBackend(BatchedBackend):
    """(T, N)·(N, N) float32 matmul field per problem, one batched matmul
    for all B (exact with TF32 off, :func:`exact_float32_matmul`).

    ``j_mode='tiled'`` ('auto' above TILED_J_THRESHOLD spins) stacks the
    adjacency instead of J and streams (tile_n, N) slabs per problem: no
    (B, N, N) buffer exists, which admits G77/G81-class buckets.
    ``field_mode='popcount'`` stacks coupling bitplanes instead (``j_bits``
    planes each, the group's maximum) and takes the XNOR-popcount field,
    row-tiled at ``tile_n`` above TILED_J_THRESHOLD spins.  ``j_dtype``
    is the stacked J's dtype, as :class:`DenseBackend`'s (ignored when
    tiled or popcount).  ``double_buffer`` builds each tiled slab before
    contracting the one before it (the same numbers).
    """

    name = "dense"

    def __init__(self, *, j_mode: str = "auto", tile_n: int = POPCOUNT_TILE_N,
                 field_mode: str = "dense", j_bits: int = 1, j_dtype=None,
                 double_buffer: bool = False, **kw):
        super().__init__(**kw)
        self.j_mode = resolve_j_mode(j_mode, self.n_bucket)
        self.tile_n = int(tile_n)
        self.double_buffer = bool(double_buffer)
        self.j_bits = int(j_bits)
        self.field_mode = resolve_field_mode(field_mode, self.j_bits)
        self._pc_tile = None if self.n_bucket <= TILED_J_THRESHOLD else self.tile_n
        held = self.field_mode != "popcount" and self.j_mode != "tiled"
        self.j_dtype = resolve_j_dtype(j_dtype if held else None)
        if self.field_mode != "popcount":
            exact_float32_matmul()

    def stack(self, models):
        if self.field_mode == "popcount":
            return _stack_packed_models(models, self.n_bucket, self.j_bits, self.device)
        if self.j_mode == "tiled":
            return _stack_sparse_models(models, self.n_bucket, self.device)
        return _stack_dense_models(models, self.n_bucket, self.device, self.j_dtype)

    def _field(self, problem, m):
        h = problem["h"][:, None]
        if self.field_mode == "popcount":
            pj = PackedJ(*(problem[k][:, None] for k in ("sign", "mags", "base")))
            return local_fields_popcount(pack_spins(m), h, pj, tile_n=self._pc_tile)
        if self.j_mode == "tiled":
            return local_fields_tiled(m, h, problem["nbr_idx"], problem["nbr_w"],
                                      tile_n=self.tile_n, double_buffer=self.double_buffer)
        return local_fields_dense(m, h, problem["J"])


class BatchedCudaBackend(_CudaDispatch, BatchedBackend):
    """The resident CUDA plateau kernels, one launch for all B problems.

    The counterpart of the JAX package's ``BatchedPallasBackend``: the
    FPGA's "one pipeline, many instances" operating mode.

    * streamed noise (xorshift's default): K1
      (:func:`~repro_torch.kernels.ssa_update.ssa_plateau_packed_batched`)
      per plateau, spins crossing the launch as 32-bit words, the lanes
      stepped in-kernel; an SSQA plateau with J⊥ ≠ 0 runs its ring mode;
    * pregenerated noise (threefry, or ``noise_mode='pregen'``): the
      (B, C, T, N) int8 noise is drawn, then K4
      (:func:`~repro_torch.kernels.ssa_update.ssa_plateau_batched`) per
      plateau;
    * ``field_mode='popcount'`` (streamed noise only): the stacked coupling
      bitplanes in K2's layout and no J, and :meth:`run_shots` makes one K2
      launch (:func:`~repro_torch.kernels.ssa_update.
      ssa_plateau_popcount_batched`) per iteration's chain, in ring mode
      where the chain's J⊥ is not all 0.  The chain's schedules go to the
      device once per backend.

    ``j_dtype`` (any of J_DTYPES) is the stacked J's dtype, which K1, K1's
    ring mode and K4 read as it is.  K2 and the ring modes need streamed
    noise, as the JAX package's batched pallas backend does.  The kernels
    size their launch (thread-block clusters) themselves, so there is no
    ``block_r``.  On CPU tensors the
    wrappers run their plain versions.
    """

    name = "cuda"

    def __init__(self, *, noise_mode: str = "auto", field_mode: str = "dense",
                 j_bits: int = 1, j_dtype=None, **kw):
        super().__init__(**kw)
        self.noise_mode = resolve_noise_mode(noise_mode, self.noise)
        self.j_bits = int(j_bits)
        self.field_mode = resolve_field_mode(field_mode, self.j_bits)
        self.j_dtype = resolve_j_dtype(j_dtype if self.field_mode != "popcount" else None)
        if self.field_mode == "popcount" and self.noise_mode != "streamed":
            raise ValueError("field_mode='popcount' on the batched cuda backend requires "
                             "noise_mode='streamed' (noise='xorshift')")
        if self.n_replicas and self.noise_mode != "streamed":
            raise ValueError("SSQA (n_replicas > 0) on the batched cuda backend requires "
                             "noise_mode='streamed' (noise='xorshift'); the pregen kernel "
                             "K4 has no replica-coupling path")
        self._schedules = {}

    def stack(self, models):
        if self.field_mode == "popcount":
            prob = _stack_packed_models(models, self.n_bucket, self.j_bits, self.device)
            pj = kssa.popcount_planes(PackedJ(prob["sign"], prob["mags"], prob["base"]))
            return {**prob, "sign": pj.sign, "mags": pj.mags}
        return _stack_dense_models(models, self.n_bucket, self.device, self.j_dtype)

    def _plateau(self, problem, st: EngineState, p: Plateau) -> EngineState:
        """K4 over the plateau's pregenerated (B, C, T, N) noise."""
        if p.jperp:
            raise ValueError("SSQA requires noise_mode='streamed' on the batched cuda "
                             "backend (the pregen kernel K4 has no replica-coupling path)")
        ns, noise = self._noise_cycles(st.noise_state, p.length)
        return self._k4(problem, st._replace(noise_state=ns), noise, p)

    def run_shots(self, problem, state, plateaus, n_shots):
        plateaus = tuple(plateaus)
        if self.noise_mode != "streamed":
            return super().run_shots(problem, state, plateaus, n_shots)
        packed = self.storage_layout == "packed"
        st = state if packed else pack_state(state)
        for _ in range(int(n_shots)):
            if self.field_mode == "popcount":
                st = self._k2(problem, st, plateaus)
            else:
                for p in plateaus:
                    st = self._k1(problem, st, p)
        return st if packed else unpack_state(st, self.n_bucket)


BATCHED_BACKENDS = {
    "sparse": BatchedSparseBackend,
    "dense": BatchedDenseBackend,
    "cuda": BatchedCudaBackend,
}


def make_batched_backend(
    backend: Optional[str] = None,
    *,
    n_bucket: int,
    n_trials: int,
    n_rnd: int = 2,
    noise: Optional[str] = None,
    partition: Optional[str] = None,
    mesh=None,
    device=None,
    config: Optional[SolverConfig] = None,
    **opts,
) -> BatchedBackend:
    """Build the named batched backend, optionally from
    ``config=SolverConfig(...)``, whose engine options are merged under
    ``opts``.  ``partition='spin'`` (or 'auto' on a mesh of several ranks)
    builds :class:`~repro_torch.core.distributed.BatchedSpinShardedBackend`
    over ``mesh``, with ``backend`` as the field arithmetic of its shards.
    ``backend='auto'`` resolves over ``n_bucket`` (:func:`resolve_backend`)."""
    if config is not None:
        backend = config.backend if backend is None else backend
        noise = config.noise if noise is None else noise
        partition = config.partition if partition is None else partition
        mesh = config.mesh if mesh is None else mesh
        opts = {**config.engine_opts(), **opts}
    backend = "sparse" if backend is None else backend
    if resolve_partition(partition or "problem", n_bucket, mesh) == "spin":
        from .distributed import BatchedSpinShardedBackend  # distributed imports this module

        return BatchedSpinShardedBackend(
            base_backend=backend, mesh=mesh, n_bucket=n_bucket, n_trials=n_trials,
            n_rnd=n_rnd, noise="xorshift" if noise is None else noise, device=device, **opts)
    backend = resolve_backend(backend, n_bucket)
    if backend not in BATCHED_BACKENDS:
        raise ValueError(f"unknown batched backend {backend!r}; known: "
                         f"{sorted(BATCHED_BACKENDS)}")
    return BATCHED_BACKENDS[backend](
        n_bucket=n_bucket, n_trials=n_trials, n_rnd=n_rnd,
        noise="xorshift" if noise is None else noise, device=device, **opts)
