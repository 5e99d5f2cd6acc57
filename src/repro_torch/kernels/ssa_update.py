"""Wrappers of the hand-written CUDA kernels of the SSA/HA-SSA spin update.

Four kernels, each the port of one Pallas kernel of
``repro/kernels/ssa_update.py``:

* K3, :func:`local_field` — ``field = h + m @ J`` on the int8 tensor cores,
  J split into byte planes (``csrc/field.cu``), int32 out.  The cycle
  loop's field when per-cycle outputs are needed.
* K1, :func:`ssa_plateau_packed_batched` and its B=1 slice
  :func:`ssa_plateau_packed` — one constant-I0 plateau of C cycles in one
  launch (``csrc/plateau.cu``): spins cross the launch boundary as 32-bit
  words, the xorshift128 lanes are stepped in-kernel, the running best is
  folded on the card.  One thread-block cluster per group of
  ``PLATEAU_GROUP`` trials, J's columns split over its blocks (the cycle
  loop of ``csrc/plateau_cycle.cuh``), its size from
  :func:`plateau_cluster_size`.  With ``n_replicas`` it runs SSQA's
  Trotter-ring mode, a kernel of its own in the same source: one
  thread-block cluster per ring, its size from :func:`ring_cluster_size`.
* K4, :func:`ssa_plateau_batched` and its B=1 slice :func:`ssa_plateau` —
  the same plateau with pregenerated noise (``csrc/plateau_pregen.cu``),
  on the same cluster loop: float32 spins, int8 best spins and a (B, C,
  R, N) int8 noise buffer.  The path of threefry noise and of
  ``noise_mode='pregen'``.
* K2, :func:`ssa_plateau_popcount_batched` and its B=1 slice
  :func:`ssa_plateau_popcount` — a whole plateau chain (per-cycle I0 and
  fold write-enable) in one launch with the XNOR-popcount field on the
  bitplanes of ``PackedJ`` (``csrc/popcount.cu``), integers only, xorshift
  noise stepped in-kernel.  The path of ``field_mode='popcount'``.  One
  thread-block cluster per group of ``PLATEAU_GROUP`` trials, the field rows
  split over its blocks, its size from :func:`popcount_cluster_size`.  With
  ``jperp_sched`` it runs SSQA's Trotter-ring mode, a kernel of its own in
  the same source: one cluster per ring.

A wrapper takes its plain version (:mod:`.ref`) only for tensors on the
CPU.  For CUDA tensors it checks device, dtype, shape and contiguity,
allocates the outputs, launches on the current stream and raises if the
launch reports an error; it never falls back.  Each wrapper counts its
launches in a ``launches`` attribute; K1's and K2's count their ring-mode
launches among them again in ``ring_launches``.  K1, K2 and K4 keep the
cluster size and block count of their last launch in ``last_cluster``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .bitplane import PackedJ, packed_words
from .ref import (
    local_field_ref,
    ssa_plateau_packed_ref,
    ssa_plateau_popcount_ref,
    ssa_plateau_ref,
)

__all__ = ["KernelLaunchError", "local_field", "ssa_plateau_packed",
           "ssa_plateau_packed_batched", "ssa_plateau", "ssa_plateau_batched", "ssa_plateau_popcount",
           "ssa_plateau_popcount_batched", "popcount_planes", "plateau_cluster_size",
           "popcount_cluster_size", "ring_cluster_size"]

# Trials per thread-block cluster of K1's classical kernel and K4 (GROUP in
# csrc/plateau_cycle.cuh): a plateau of R trials runs ceil(R / GROUP)
# clusters per problem, the last one ragged.
PLATEAU_GROUP = _build.header_int("plateau_cycle.cuh", "GROUP")

# Dynamic shared memory one H100 block may use.
_MAX_SMEM = 232448

# Blocks per thread-block cluster of K1 and K2 (classical and ring mode) and K4:
# the powers of two up to the kernels' MAX_CS, 16, which Hopper allows as a
# non-portable size where the occupancy query says such a cluster fits (8
# is portable).
CLUSTER_SIZES = tuple(
    1 << i for i in range(_build.header_int("plateau_cycle.cuh", "MAX_CS").bit_length()))
# K3's block tile (rows, columns, k per stage) and its most K splits, blocks
# per thread-block cluster (csrc/field.cu).
_K3_BM, _K3_BN, _K3_BK = (_build.header_int("field.cu", n) for n in ("BM", "BN", "BK"))
_K3_MAX_SPLITS = _build.header_int("field.cu", "MAX_KS")
# The work area of a K1 or K4 block: KC k of GROUP signs, floats.
_WORK_BYTES = 4 * _build.header_int("plateau_cycle.cuh", "KC") * PLATEAU_GROUP
# Warps of a K1 or K4 block (K1's ring mode keeps an energy share per warp).
_WARPS = _build.header_int("plateau_cycle.cuh", "THREADS") // 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_local_field": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_local_field_max_clusters": [_I] * 3,
    "repro_ssa_plateau_packed": [_P] * 5 + [_I] + [_P] * 7 + [_I] * 8 + [_P],
    "repro_ssa_plateau": [_P] * 5 + [_I] + [_P] * 6 + [_I] * 8 + [_P],
    "repro_ssa_plateau_popcount": [_P] * 17 + [_I] * 8 + [_P],
    "repro_ssa_plateau_packed_ring": [_P] * 5 + [_I] * 2 + [_P] * 8 + [_I] * 9 + [_P],
    "repro_plateau_max_clusters": [_I] * 5,
    "repro_plateau_pregen_max_clusters": [_I] * 3,
    "repro_ssa_plateau_popcount_ring": [_P] * 18 + [_I] * 9 + [_P],
    "repro_popcount_max_clusters": [_I] * 5,
    "repro_popcount_smem": [_I] * 5,
    "repro_popcount_global_words": [_I] * 4,
}
# Entries that return a size, not an error code.
_LONG = ("repro_popcount_smem", "repro_popcount_global_words")


def _entry(lib: str, fn: str):
    lib_ = _build.library(lib)
    f = getattr(lib_, fn)
    if f.argtypes is None:
        f.argtypes = _SIGNATURES[fn]
        f.restype = ctypes.c_longlong if fn in _LONG else ctypes.c_int
        lib_.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib_.repro_cuda_error_string.restype = ctypes.c_char_p
    return f, lib_


def _device_of(*tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check(name: str, t: torch.Tensor, shape, dtypes, contiguous: bool = True):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_ring(R: int, n_replicas: int, what: str):
    """Validation of a ring-mode call, as the JAX wrappers make it: a ring
    of any size that divides the trials."""
    if n_replicas < 1:
        raise ValueError(f"{what}: n_replicas must be >= 1, got {n_replicas}")
    if R % n_replicas:
        raise ValueError(f"n_trials={R} not divisible by n_replicas={n_replicas}")


def _cluster_size(n_clusters: int, sm_count: int, sizes, max_clusters=None) -> int:
    """Blocks per thread-block cluster for a launch of ``n_clusters``
    clusters: the largest of ``sizes`` with ``n_clusters · size <= sm_count``,
    so every block has an SM, and, where ``max_clusters`` (size -> clusters
    the card runs at once, the occupancy query) is given, with every cluster
    running at once, since a second wave would double the time.  1 when none
    is larger.  The rule of K3's K splits and of the K1, K2 and K4 clusters."""
    for cs in sorted(sizes, reverse=True):
        if cs > 1 and n_clusters * cs <= sm_count and (
                max_clusters is None or max_clusters(cs) >= n_clusters):
            return cs
    return 1


def _word_sizes(N: int):
    """The cluster sizes of a K1 or K4 launch at N spins: every block owns
    at least one 32-column word."""
    return [cs for cs in CLUSTER_SIZES if cs <= packed_words(N)]


def ring_cluster_size(n_rings: int, B: int, N: int, sm_count: int, max_clusters=None) -> int:
    """Blocks per ring for K1's ring mode: by :func:`_cluster_size`, the
    largest CS of 1, 2, 4, 8, 16 with ``n_rings · B · CS <= sm_count`` and
    ``CS <= Nw``, so every block owns at least one 32-column word, and, given
    ``max_clusters``, every ring's cluster running at once (the non-portable
    16 needs that query).  1 when the rings alone fill the card."""
    return _cluster_size(n_rings * B, sm_count, _word_sizes(N), max_clusters)


def plateau_groups(R: int) -> int:
    """Clusters per problem of K1's classical kernel and K4: one per group
    of PLATEAU_GROUP trials, the last one ragged."""
    return -(-R // PLATEAU_GROUP)


def plateau_cluster_size(R: int, B: int, N: int, sm_count: int, max_clusters=None) -> int:
    """Blocks per group of trials for K1's classical kernel and K4: by
    :func:`_cluster_size` over the ``plateau_groups(R) · B`` groups, the
    largest CS of 1, 2, 4, 8, 16 up to Nw with every block on an SM and,
    given ``max_clusters``, every group's cluster running at once."""
    return _cluster_size(plateau_groups(R) * B, sm_count, _word_sizes(N), max_clusters)


def popcount_cluster_size(R: int, B: int, N: int, sm_count: int, max_clusters=None,
                          n_replicas: int = 0, resident=None) -> int:
    """Blocks per unit of K2 (``plateau_groups(R)`` groups of trials in the
    classical mode, ``R // n_replicas`` rings in the ring mode; B problems'
    units together), by :func:`_cluster_size`: the largest CS of 1, 2, 4,
    8, 16 up to Nw with every block on an SM and, given ``max_clusters``,
    every unit's cluster running at once.

    Given ``resident`` (size -> whether a block of that size holds its
    planes and state in shared memory), the sizes that do come first: the
    largest of them that runs in one wave, else the smallest of them (the
    fewest waves), since a streamed block runs the same words slower than
    a second wave of resident ones (B = 2 at K2000 on an H100, the ``[K2
    B=2 sweep]`` of chip_smoke.py: 8.2 ms in two waves of clusters of 8,
    11.2 ms in one of 4, streamed).  The one-wave rule over every size
    where none is resident."""
    units = (R // n_replicas if n_replicas else plateau_groups(R)) * B
    sizes = _word_sizes(N)
    if resident is not None:
        held = [c for c in sizes if resident(c) and (max_clusters is None or max_clusters(c))]
        one_wave = [c for c in held if units * c <= sm_count and (
            max_clusters is None or max_clusters(c) >= units)]
        if held:
            return max(one_wave) if one_wave else min(held)
    return _cluster_size(units, sm_count, sizes, max_clusters)


# K2's block variants, by what a block keeps in shared memory, most first
# (Variant in csrc/popcount.cu, in its order): the unit's spin words, the
# best words of its slice and the slice's planes and state ("resident");
# the words only, the planes and state read from global memory
# ("streamed"); nothing of size N ("global": the words too in global
# memory).
POPCOUNT_VARIANTS = ("resident", "streamed", "global")


def popcount_variant(smem_bytes) -> str:
    """The first of :data:`POPCOUNT_VARIANTS` whose block fits an H100's
    shared memory; ``smem_bytes(variant)`` is a block's size (on the card,
    the kernel's own ``repro_popcount_smem``): chosen by size, never on
    failure."""
    for v in POPCOUNT_VARIANTS:
        if smem_bytes(v) <= _MAX_SMEM:
            return v
    raise ValueError(f"no K2 block variant fits {_MAX_SMEM} B of shared memory")


def _popcount_smem(N: int, nb: int, n_replicas: int, cs: int, variant: str) -> int:
    """Shared memory of one K2 block, from the kernel's layout."""
    fn, _ = _entry("popcount", "repro_popcount_smem")
    return fn(N, nb, n_replicas, cs, POPCOUNT_VARIANTS.index(variant))


def _k3_splits(R: int, N: int, sm_count: int, max_clusters=None) -> int:
    """K3's K splits by :func:`_cluster_size`: one cluster per block tile, at
    most MAX_KS blocks and one k stage per block."""
    tiles = -(-N // _K3_BN) * -(-R // _K3_BM)
    sizes = range(1, min(_K3_MAX_SPLITS, -(-N // _K3_BK)) + 1)
    return _cluster_size(tiles, sm_count, sizes, max_clusters)


_launch_cache: dict = {}


def _cached(key, choose):
    """``choose()``, once per key: a launch's cluster size, by device and
    shape, so the occupancy queries run on a call's first launch only."""
    if key not in _launch_cache:
        _launch_cache[key] = choose()
    return _launch_cache[key]


def _max_clusters(dev: torch.device, lib: str, entry: str, *args) -> int:
    """The occupancy query ``entry`` of library ``lib`` on ``dev``: how many
    clusters of the size in ``args`` the card runs at once."""
    fn, lib_ = _entry(lib, entry)
    with torch.cuda.device(dev):
        n = fn(*args)
    if n < 0:
        raise RuntimeError(f"{entry} failed with CUDA error {-n} "
                           f"({lib_.repro_cuda_error_string(-n).decode()})")
    return n


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# Where a block of K1's ring mode keeps the ring's spin words (csrc/plateau.cu,
# ring_kernel), most first: in its shared memory, a copy in every block of
# the cluster ("shared"), or one copy per cluster in global memory, the best
# words in the output ("global").
RING_VARIANTS = ("shared", "global")


def ring_variant(N: int, n_replicas: int, cs: int) -> str:
    """The first of :data:`RING_VARIANTS` whose K1 ring-mode block, in
    clusters of ``cs`` blocks, fits an H100's shared memory: chosen by size,
    never on failure.  ValueError where not even the per-replica arrays fit."""
    for v in RING_VARIANTS:
        if _ring_smem(N, n_replicas, cs, v) <= _MAX_SMEM:
            return v
    raise ValueError(f"K1's ring mode at N={N}, rings of {n_replicas}, clusters of {cs}: no "
                     f"block variant fits {_MAX_SMEM} B of shared memory")


def _ring_smem(N: int, n_replicas: int, cs: int, variant: str = "shared") -> int:
    """Shared memory of one K1 ring-mode block (``ring_smem`` in
    csrc/plateau.cu): the work area and the per-replica arrays (best
    energies and flags, per-warp and per-block energy shares); with the
    words in shared memory also the best words of its slice and the ring's
    ceil(R/32) words per column, double-buffered."""
    head = _WORK_BYTES + 4 * n_replicas * (2 + _WARPS + 2 * cs)
    if variant == "global":
        return head
    return head + 4 * (n_replicas * -(-packed_words(N) // cs) + 2 * -(-n_replicas // 32) * N)


def _ring_global_words(N: int, n_replicas: int, R: int, B: int) -> int:
    """32-bit words of the global word buffer of the ``R // n_replicas``
    rings of B problems: [B][ring][2][ceil(n_replicas/32)][N] (the layout
    of ring_kernel's ``words`` in csrc/plateau.cu)."""
    return B * (R // n_replicas) * 2 * -(-n_replicas // 32) * N


def _plateau_smem(N: int, cs: int, best_words: bool) -> int:
    """Shared memory of one block of K1's classical kernel (``best_words``:
    the best words of its slice beside) or of K4: the work area and the
    group's spin words double-buffered."""
    best = PLATEAU_GROUP * -(-packed_words(N) // cs) if best_words else 0
    return _WORK_BYTES + 4 * (2 * N + best)


def _check_cluster_size(cluster_size, N: int):
    """A forced cluster size must be one the kernels take and at most the
    word count of N, as on the card; checked on every device."""
    nw = packed_words(N)
    if int(cluster_size) not in CLUSTER_SIZES or int(cluster_size) > nw:
        raise ValueError(f"cluster_size={cluster_size}: must be one of {CLUSTER_SIZES} and at "
                         f"most the {nw} words of N={N}")


def _plateau_cs(dev: torch.device, lib: str, entry: str, R: int, B: int, N: int, jtype: int,
                cluster_size, head=(), tail=()) -> int:
    """The cluster size of a K1 classical or K4 launch: ``cluster_size`` if
    forced, else :func:`plateau_cluster_size` with the occupancy query
    ``entry(N, *head, cs, jtype, *tail)`` of library ``lib``, once per shape."""
    if cluster_size is not None:
        return int(cluster_size)
    return _cached((lib, dev.index, B, R, N, jtype), lambda: plateau_cluster_size(
        R, B, N, _sm_count(dev), lambda cs: _max_clusters(
            dev, lib, entry, N, *head, cs, jtype, *tail)))


def _check_smem(what: str, smem: int):
    if smem > _MAX_SMEM:
        raise ValueError(f"{what} needs {smem} B of shared memory per block (> {_MAX_SMEM})")


class KernelLaunchError(RuntimeError):
    """A kernel launch reported a CUDA error."""


def _launch(fn, lib, what: str, dev: torch.device, *args):
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise KernelLaunchError(f"{what}: CUDA launch failed with error {err} ({msg})")


# The dtypes K1, K1's ring mode, K3 and K4 take J in, in the order of the
# type codes of csrc/jtype.cuh: each is widened exactly on load (every value
# is an integer below 2^24, as the host rounded or wrapped it).
_J_TYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.uint8, torch.int16,
            torch.int32)


def _jtype(J: torch.Tensor) -> int:
    """J's type code (csrc/jtype.cuh)."""
    return _J_TYPES.index(J.dtype)


def local_field(m: torch.Tensor, h: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """K3: field = h + m @ J, int32 exact.

    ``m`` (R, N) ±1 of any dtype, ``h`` (N,) integer, ``J`` (N, N) of any of
    the seven dtypes of ``_J_TYPES``, integer-valued.  Replaces
    ``repro/kernels/ssa_update.py:local_field`` (``_field_kernel``).
    """
    return _local_field(m, h, J)


def _local_field(m: torch.Tensor, h: torch.Tensor, J: torch.Tensor,
                 splits: Optional[int] = None) -> torch.Tensor:
    """:func:`local_field`, with ``splits`` forcing K3's K splits (1 to
    MAX_KS) for measurement; None takes :func:`_k3_splits`'s choice."""
    dev = _device_of(m, h, J)
    if dev.type == "cpu":
        return local_field_ref(m, h, J)
    if m.dim() != 2:
        raise ValueError(f"m: expected (R, N), got shape {tuple(m.shape)}")
    R, N = m.shape
    mf = m.to(torch.float32).contiguous()
    h32 = h.to(torch.int32).contiguous()
    _check("h", h32, (N,), (torch.int32,))
    _check("J", J, (N, N), _J_TYPES)
    out = torch.empty((R, N), dtype=torch.int32, device=dev)
    if R == 0 or N == 0:
        return out
    jt = _jtype(J)
    if splits is None:
        splits = _cached(("field", dev.index, R, N, jt), lambda: _k3_splits(
            R, N, _sm_count(dev), lambda ks: _max_clusters(
                dev, "field", "repro_local_field_max_clusters", N, ks, jt)))
    elif not 1 <= int(splits) <= _K3_MAX_SPLITS:
        raise ValueError(f"splits={splits}: must be 1 to {_K3_MAX_SPLITS}")
    fn, lib = _entry("field", "repro_local_field")
    _launch(fn, lib, "local_field", dev, mf.data_ptr(), J.data_ptr(), h32.data_ptr(),
            out.data_ptr(), R, N, jt, int(splits))
    local_field.launches += 1
    return out


local_field.launches = 0


def ssa_plateau_packed_batched(
    m_packed: torch.Tensor,       # (B, R, Nw) int32 words
    itanh: torch.Tensor,          # (B, R, N) int32
    J: torch.Tensor,              # (B, N, N), any dtype of _J_TYPES
    h: torch.Tensor,              # (B, N) int32
    rng: torch.Tensor,            # (B, 4, R, N) int32 xorshift lanes
    i0: int,
    best_H: torch.Tensor,         # (B, R) int32
    best_m_packed: torch.Tensor,  # (B, R, Nw) int32 words
    *,
    n_cycles: int,
    n_rnd: int = 2,
    eligible: bool = True,
    jperp: int = 0,
    n_replicas: int = 0,
    cluster_size: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """K1: one constant-I0 plateau for B problems × R trials, one launch.

    Semantics are those of :func:`~repro_torch.kernels.ref.
    ssa_plateau_packed_ref`.  Replaces
    ``repro/kernels/ssa_update.py:ssa_plateau_packed_batched``
    (``_plateau_streamed_kernel``), in both its modes: ``n_replicas == 0``
    runs the classical kernel; ``n_replicas > 0`` the SSQA ring-mode
    kernel, which adds ``jperp · (m[k-1] + m[k+1])`` over rings of
    ``n_replicas`` consecutive trials to the update field (R must be a
    multiple of ``n_replicas``; a ring may hold any number of replicas).
    The classical kernel runs each group of PLATEAU_GROUP trials as one
    thread-block cluster of :func:`plateau_cluster_size` blocks, the ring
    mode each ring as one of :func:`ring_cluster_size` blocks, keeping the
    ring's spin words in shared memory or, where they do not fit, in global
    memory (:func:`ring_variant`; the last ring launch's in
    ``ssa_plateau_packed_batched.last_ring_variant``);
    ``cluster_size`` forces that size, for tests and measurement (any of 1,
    2, 4, 8, 16 up to the word count of N; checked, then ignored, on the
    CPU).  The size and block count of the last launch are kept in
    ``ssa_plateau_packed_batched.last_cluster``.

    Returns (m_packed, itanh, rng, best_H, best_m_packed).
    """
    args = (m_packed, itanh, J, h, rng, best_H, best_m_packed)
    dev = _device_of(*args)
    if itanh.dim() != 3:
        raise ValueError(f"itanh: expected (B, R, N), got shape {tuple(itanh.shape)}")
    n_replicas = int(n_replicas)
    if n_replicas:
        _check_ring(itanh.shape[1], n_replicas, "ssa_plateau_packed")
    if cluster_size is not None:
        _check_cluster_size(cluster_size, itanh.shape[2])
    if dev.type == "cpu":
        return ssa_plateau_packed_ref(
            m_packed, itanh, J, h, rng, i0, best_H, best_m_packed,
            n_cycles=n_cycles, n_rnd=n_rnd, eligible=eligible,
            jperp=jperp, n_replicas=n_replicas,
        )
    B, R, N = itanh.shape
    nw = packed_words(N)
    i32 = (torch.int32,)
    _check("m_packed", m_packed, (B, R, nw), i32)
    _check("itanh", itanh, (B, R, N), i32)
    _check("J", J, (B, N, N), _J_TYPES)
    _check("h", h, (B, N), i32)
    _check("rng", rng, (B, 4, R, N), i32)
    _check("best_H", best_H, (B, R), i32)
    _check("best_m_packed", best_m_packed, (B, R, nw), i32)
    if int(n_cycles) < 0:
        raise ValueError(f"n_cycles must be >= 0, got {n_cycles}")
    jt = _jtype(J)
    if n_replicas:
        n_rings = R // n_replicas
        if cluster_size is None:
            cs = _cached(("ring", dev.index, B, n_rings, N, n_replicas, jt),
                         lambda: ring_cluster_size(n_rings, B, N, _sm_count(dev), lambda c: (
                             _max_clusters(dev, "plateau", "repro_plateau_max_clusters",
                                           N, n_replicas, c, jt,
                                           RING_VARIANTS.index(ring_variant(N, n_replicas, c))))))
        else:
            cs = int(cluster_size)
        variant = ring_variant(N, n_replicas, cs)
    else:
        # n_replicas = 0: the classical kernel (its words always in shared memory)
        cs = _plateau_cs(dev, "plateau", "repro_plateau_max_clusters", R, B, N, jt,
                         cluster_size, head=(0,), tail=(0,))
        _check_smem(f"K1 at N={N}", _plateau_smem(N, cs, best_words=True))
    outs = tuple(torch.empty_like(t) for t in
                 (m_packed, itanh, rng, best_H, best_m_packed))
    if B == 0 or R == 0:
        return outs
    mp_o, it_o, rng_o, bh_o, bmp_o = outs
    if n_replicas:
        words = None  # the rings' spin words, where no block holds them
        if variant == "global":
            words = torch.empty(_ring_global_words(N, n_replicas, R, B), dtype=torch.int32,
                                device=dev)
        fn, lib = _entry("plateau", "repro_ssa_plateau_packed_ring")
        _launch(
            fn, lib, f"ssa_plateau_packed (ring mode, rings of {n_replicas}, clusters of {cs} "
            f"blocks, words {variant}, N={N})", dev,
            m_packed.data_ptr(), itanh.data_ptr(), J.data_ptr(), h.data_ptr(),
            rng.data_ptr(), int(i0), int(jperp), best_H.data_ptr(),
            best_m_packed.data_ptr(), mp_o.data_ptr(), it_o.data_ptr(), rng_o.data_ptr(),
            bh_o.data_ptr(), bmp_o.data_ptr(), None if words is None else words.data_ptr(),
            B, R, N, int(n_cycles), int(n_rnd), int(bool(eligible)), jt, n_replicas, cs,
        )
        ssa_plateau_packed_batched.launches += 1
        ssa_plateau_packed_batched.ring_launches += 1
        ssa_plateau_packed_batched.last_cluster = (cs, n_rings * B * cs)
        ssa_plateau_packed_batched.last_ring_variant = variant
        return outs
    fn, lib = _entry("plateau", "repro_ssa_plateau_packed")
    _launch(
        fn, lib, f"ssa_plateau_packed (clusters of {cs} blocks, N={N})", dev,
        m_packed.data_ptr(), itanh.data_ptr(), J.data_ptr(), h.data_ptr(),
        rng.data_ptr(), int(i0), best_H.data_ptr(), best_m_packed.data_ptr(),
        mp_o.data_ptr(), it_o.data_ptr(), rng_o.data_ptr(), bh_o.data_ptr(),
        bmp_o.data_ptr(), B, R, N, int(n_cycles), int(n_rnd), int(bool(eligible)),
        jt, cs,
    )
    ssa_plateau_packed_batched.launches += 1
    ssa_plateau_packed_batched.last_cluster = (cs, plateau_groups(R) * B * cs)
    return outs


ssa_plateau_packed_batched.launches = 0
ssa_plateau_packed_batched.ring_launches = 0
ssa_plateau_packed_batched.last_cluster = None
ssa_plateau_packed_batched.last_ring_variant = None


def ssa_plateau_packed(
    m_packed: torch.Tensor,       # (R, Nw)
    itanh: torch.Tensor,          # (R, N)
    J: torch.Tensor,              # (N, N)
    h: torch.Tensor,              # (N,)
    rng: torch.Tensor,            # (4, R, N)
    i0: int,
    best_H: torch.Tensor,         # (R,)
    best_m_packed: torch.Tensor,  # (R, Nw)
    *,
    n_cycles: int,
    n_rnd: int = 2,
    eligible: bool = True,
    jperp: int = 0,
    n_replicas: int = 0,
):
    """B=1 slice of :func:`ssa_plateau_packed_batched` (the same kernels)."""
    outs = ssa_plateau_packed_batched(
        m_packed[None], itanh[None], J[None], h[None], rng[None], i0,
        best_H[None], best_m_packed[None],
        n_cycles=n_cycles, n_rnd=n_rnd, eligible=eligible,
        jperp=jperp, n_replicas=n_replicas,
    )
    return tuple(o[0] for o in outs)


def ssa_plateau_batched(
    m: torch.Tensor,       # (B, R, N) float32 ±1
    itanh: torch.Tensor,   # (B, R, N) int32
    J: torch.Tensor,       # (B, N, N), any dtype of _J_TYPES
    h: torch.Tensor,       # (B, N) int32
    noise: torch.Tensor,   # (B, C, R, N) int8 ±1
    i0: int,
    best_H: torch.Tensor,  # (B, R) int32
    best_m: torch.Tensor,  # (B, R, N) int8
    *,
    n_rnd: int = 2,
    eligible: bool = True,
    cluster_size: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """K4: one constant-I0 plateau of C = ``noise.shape[1]`` cycles with
    pregenerated noise, for B problems × R trials, one launch.

    Semantics are those of :func:`~repro_torch.kernels.ref.ssa_plateau_ref`.
    Replaces ``repro/kernels/ssa_update.py:ssa_plateau_batched``
    (``_plateau_kernel``).  Each group of PLATEAU_GROUP trials runs as one
    thread-block cluster of :func:`plateau_cluster_size` blocks;
    ``cluster_size`` forces that size, as K1's does.  The size and block
    count of the last launch are kept in ``ssa_plateau_batched.last_cluster``.

    Returns (m float32, itanh, best_H, best_m int8).
    """
    args = (m, itanh, J, h, noise, best_H, best_m)
    dev = _device_of(*args)
    if cluster_size is not None:
        _check_cluster_size(cluster_size, m.shape[-1])
    if dev.type == "cpu":
        return ssa_plateau_ref(m, itanh, J, h, noise, i0, best_H, best_m,
                               n_rnd=n_rnd, eligible=eligible)
    if m.dim() != 3 or noise.dim() != 4:
        raise ValueError(f"m: expected (B, R, N) and noise (B, C, R, N), got "
                         f"{tuple(m.shape)} and {tuple(noise.shape)}")
    B, R, N = m.shape
    C = noise.shape[1]
    _check("m", m, (B, R, N), (torch.float32,))
    _check("itanh", itanh, (B, R, N), (torch.int32,))
    _check("J", J, (B, N, N), _J_TYPES)
    _check("h", h, (B, N), (torch.int32,))
    _check("noise", noise, (B, C, R, N), (torch.int8,))
    _check("best_H", best_H, (B, R), (torch.int32,))
    _check("best_m", best_m, (B, R, N), (torch.int8,))
    jt = _jtype(J)
    cs = _plateau_cs(dev, "plateau_pregen", "repro_plateau_pregen_max_clusters", R, B, N, jt,
                     cluster_size)
    _check_smem(f"K4 at N={N}", _plateau_smem(N, cs, best_words=False))
    outs = tuple(torch.empty_like(t) for t in (m, itanh, best_H, best_m))
    if B == 0 or R == 0:
        return outs
    m_o, it_o, bh_o, bm_o = outs
    fn, lib = _entry("plateau_pregen", "repro_ssa_plateau")
    _launch(
        fn, lib, f"ssa_plateau (clusters of {cs} blocks, N={N})", dev,
        m.data_ptr(), itanh.data_ptr(), J.data_ptr(), h.data_ptr(), noise.data_ptr(),
        int(i0), best_H.data_ptr(), best_m.data_ptr(),
        m_o.data_ptr(), it_o.data_ptr(), bh_o.data_ptr(), bm_o.data_ptr(),
        B, R, N, C, int(n_rnd), int(bool(eligible)), jt, cs,
    )
    ssa_plateau_batched.launches += 1
    ssa_plateau_batched.last_cluster = (cs, plateau_groups(R) * B * cs)
    return outs


ssa_plateau_batched.launches = 0
ssa_plateau_batched.last_cluster = None


def ssa_plateau(
    m: torch.Tensor,       # (R, N) float32
    itanh: torch.Tensor,   # (R, N) int32
    J: torch.Tensor,       # (N, N)
    h: torch.Tensor,       # (N,) int32
    noise: torch.Tensor,   # (C, R, N) int8
    i0: int,
    best_H: torch.Tensor,  # (R,) int32
    best_m: torch.Tensor,  # (R, N) int8
    *,
    n_rnd: int = 2,
    eligible: bool = True,
):
    """B=1 slice of :func:`ssa_plateau_batched` (the same kernel)."""
    outs = ssa_plateau_batched(
        m[None], itanh[None], J[None], h[None], noise[None], i0,
        best_H[None], best_m[None], n_rnd=n_rnd, eligible=eligible,
    )
    return tuple(o[0] for o in outs)


def popcount_planes(packed_j: PackedJ) -> PackedJ:
    """``packed_j`` with each (N, Nw) plane stored [Nw][N], the layout K2
    reads: the shapes stay, the planes become transposed views, so
    :func:`ssa_plateau_popcount_batched` hands them to the kernel without a
    copy.  Made once per set of couplings; the plain popcount field reads
    the views as it reads any planes."""
    def t(x):
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)

    return packed_j._replace(sign=t(packed_j.sign), mags=t(packed_j.mags))


def ssa_plateau_popcount_batched(
    m_packed: torch.Tensor,       # (B, R, Nw) int32 words
    itanh: torch.Tensor,          # (B, R, N) int32
    sign: torch.Tensor,           # (B, N, Nw) int32 words, PackedJ.sign
    mags: torch.Tensor,           # (B, nb, N, Nw) int32 words, PackedJ.mags
    base: torch.Tensor,           # (B, N) int32, PackedJ.base
    h: torch.Tensor,              # (B, N) int32
    rng: torch.Tensor,            # (B, 4, R, N) int32 xorshift lanes
    i0_sched: torch.Tensor,       # (C,) int32 per-cycle I0
    fold_sched: torch.Tensor,     # (C+1,) int32 per-state fold write-enable
    best_H: torch.Tensor,         # (B, R) int32
    best_m_packed: torch.Tensor,  # (B, R, Nw) int32 words
    *,
    n_rnd: int = 2,
    jperp_sched: Optional[torch.Tensor] = None,  # (C,) int32 per-cycle J⊥
    n_replicas: int = 0,
    cluster_size: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """K2: a plateau chain of C = ``len(i0_sched)`` cycles for B problems ×
    R trials, one launch, with the XNOR-popcount field.

    Semantics are those of :func:`~repro_torch.kernels.ref.
    ssa_plateau_popcount_ref`; the schedules come from
    :func:`repro_torch.core.engine.plateau_cycle_schedules`.  Replaces
    ``repro/kernels/ssa_update.py:ssa_plateau_popcount_batched``
    (``_plateau_popcount_kernel``), in both its modes: without
    ``jperp_sched`` the classical kernel, with it the SSQA ring-mode
    kernel, which adds ``jperp_sched[c] · (m[k-1] + m[k+1])`` over rings of
    ``n_replicas`` consecutive trials to the update of cycle c.  As in the
    JAX package, ``n_replicas`` without ``jperp_sched`` runs the classical
    kernel, and ``jperp_sched`` without ``n_replicas`` raises ValueError.

    The classical kernel runs each group of PLATEAU_GROUP trials, the ring
    mode each ring, as one thread-block cluster of
    :func:`popcount_cluster_size` blocks that split the field rows;
    ``cluster_size`` forces that size, for tests and measurement (any of 1,
    2, 4, 8, 16 up to the word count of N; checked, then ignored, on the
    CPU).  Where a block's slice of the planes and its state fit its shared
    memory they stay there for the whole chain; otherwise the same loop
    reads them from global memory, and where not even the unit's spin words
    fit, those too (:func:`popcount_variant`).  The size, block count and
    variant (one of :data:`POPCOUNT_VARIANTS`) of the last launch are kept
    in ``ssa_plateau_popcount_batched.last_cluster`` as (cs, blocks,
    variant).

    ``sign`` and ``mags`` may be in any memory layout; planes not already
    stored [Nw][N] (see :func:`popcount_planes`) are copied to it for the
    launch.

    Returns (m_packed, itanh, rng, best_H, best_m_packed).
    """
    args = (m_packed, itanh, sign, mags, base, h, rng, i0_sched, fold_sched, best_H,
            best_m_packed)
    dev = _device_of(*args)
    if itanh.dim() != 3 or mags.dim() != 4 or i0_sched.dim() != 1:
        raise ValueError(f"itanh: expected (B, R, N), mags (B, nb, N, Nw) and i0_sched "
                         f"(C,), got {tuple(itanh.shape)}, {tuple(mags.shape)} and "
                         f"{tuple(i0_sched.shape)}")
    if jperp_sched is None:
        n_replicas = 0
    elif not n_replicas:
        raise ValueError("jperp_sched given but n_replicas == 0")
    else:
        n_replicas = int(n_replicas)
        _check_ring(itanh.shape[1], n_replicas, "ssa_plateau_popcount")
        _device_of(jperp_sched, itanh)
    if cluster_size is not None:
        _check_cluster_size(cluster_size, itanh.shape[2])
    if dev.type == "cpu":
        return ssa_plateau_popcount_ref(*args, n_rnd=n_rnd, jperp_sched=jperp_sched,
                                        n_replicas=n_replicas)
    B, R, N = itanh.shape
    nb, C = mags.shape[1], i0_sched.shape[0]
    nw = packed_words(N)
    i32 = (torch.int32,)
    _check("m_packed", m_packed, (B, R, nw), i32)
    _check("itanh", itanh, (B, R, N), i32)
    _check("sign", sign, (B, N, nw), i32, contiguous=False)
    _check("mags", mags, (B, nb, N, nw), i32, contiguous=False)
    _check("base", base, (B, N), i32)
    _check("h", h, (B, N), i32)
    _check("rng", rng, (B, 4, R, N), i32)
    _check("i0_sched", i0_sched, (C,), i32)
    _check("fold_sched", fold_sched, (C + 1,), i32)
    _check("best_H", best_H, (B, R), i32)
    _check("best_m_packed", best_m_packed, (B, R, nw), i32)
    if nb < 1:
        raise ValueError("mags: need at least one magnitude plane")
    if n_replicas:
        _check("jperp_sched", jperp_sched, (C,), i32)

    def variant_at(c):  # the block variant of clusters of c blocks
        return _cached(("popcount variant", N, nb, n_replicas, c), lambda: popcount_variant(
            lambda v: _popcount_smem(N, nb, n_replicas, c, v)))

    if cluster_size is None:
        def fits(c):  # clusters of c blocks the card runs at once
            return _max_clusters(dev, "popcount", "repro_popcount_max_clusters", N, n_replicas,
                                 nb, c, POPCOUNT_VARIANTS.index(variant_at(c)))
        cs = _cached(("popcount", dev.index, B, R, N, nb, n_replicas), lambda: (
            popcount_cluster_size(R, B, N, _sm_count(dev), fits, n_replicas,
                                  lambda c: variant_at(c) == "resident")))
    else:
        cs = int(cluster_size)
    variant = variant_at(cs)
    mode = " ring mode" if n_replicas else ""
    outs = tuple(torch.empty_like(t) for t in
                 (m_packed, itanh, rng, best_H, best_m_packed))
    if B == 0 or R == 0:
        return outs
    words = None  # the units' spin words, where no block holds them
    if variant == "global":
        fn, _ = _entry("popcount", "repro_popcount_global_words")
        words = torch.empty(fn(N, n_replicas, R, B), dtype=torch.int32, device=dev)
    # The kernel reads each plane transposed, [Nw][N]: a warp's loads of one
    # word index fall on consecutive addresses.  No copy when the planes
    # come from popcount_planes.
    sign_t = sign.transpose(1, 2).contiguous()
    mags_t = mags.transpose(2, 3).contiguous()
    mp_o, it_o, rng_o, bh_o, bmp_o = outs
    ptrs = (m_packed.data_ptr(), itanh.data_ptr(), sign_t.data_ptr(), mags_t.data_ptr(),
            base.data_ptr(), h.data_ptr(), rng.data_ptr(), i0_sched.data_ptr())
    tail = (fold_sched.data_ptr(), best_H.data_ptr(), best_m_packed.data_ptr(),
            mp_o.data_ptr(), it_o.data_ptr(), rng_o.data_ptr(), bh_o.data_ptr(),
            bmp_o.data_ptr(), None if words is None else words.data_ptr(),
            B, R, N, nb, C, int(n_rnd))
    what = f"ssa_plateau_popcount{mode} (clusters of {cs} blocks, N={N})"
    if n_replicas:
        fn, lib = _entry("popcount", "repro_ssa_plateau_popcount_ring")
        _launch(fn, lib, what, dev, *ptrs, jperp_sched.data_ptr(), *tail, n_replicas, cs,
                POPCOUNT_VARIANTS.index(variant))
        ssa_plateau_popcount_batched.ring_launches += 1
    else:
        fn, lib = _entry("popcount", "repro_ssa_plateau_popcount")
        _launch(fn, lib, what, dev, *ptrs, *tail, cs, POPCOUNT_VARIANTS.index(variant))
    ssa_plateau_popcount_batched.launches += 1
    units = R // n_replicas if n_replicas else plateau_groups(R)
    ssa_plateau_popcount_batched.last_cluster = (cs, units * B * cs, variant)
    return outs


ssa_plateau_popcount_batched.launches = 0
ssa_plateau_popcount_batched.ring_launches = 0
ssa_plateau_popcount_batched.last_cluster = None


def ssa_plateau_popcount(
    m_packed: torch.Tensor,       # (R, Nw)
    itanh: torch.Tensor,          # (R, N)
    sign: torch.Tensor,           # (N, Nw)
    mags: torch.Tensor,           # (nb, N, Nw)
    base: torch.Tensor,           # (N,)
    h: torch.Tensor,              # (N,)
    rng: torch.Tensor,            # (4, R, N)
    i0_sched: torch.Tensor,       # (C,)
    fold_sched: torch.Tensor,     # (C+1,)
    best_H: torch.Tensor,         # (R,)
    best_m_packed: torch.Tensor,  # (R, Nw)
    *,
    n_rnd: int = 2,
    jperp_sched=None,
    n_replicas: int = 0,
):
    """B=1 slice of :func:`ssa_plateau_popcount_batched` (the same kernels)."""
    outs = ssa_plateau_popcount_batched(
        m_packed[None], itanh[None], sign[None], mags[None], base[None], h[None],
        rng[None], i0_sched, fold_sched, best_H[None], best_m_packed[None],
        n_rnd=n_rnd, jperp_sched=jperp_sched, n_replicas=n_replicas,
    )
    return tuple(o[0] for o in outs)
