"""The fused HA-SSA iteration steps on a ``data`` × ``model`` mesh, their
dry-run lowerings, and spin-sharded execution, ``partition='spin'`` (port
of ``repro.core.distributed``).

:func:`make_iteration_step` runs one whole I0min→I0max HA-SSA iteration as
a plain function of the state tuple: the chain of the iteration's
constant-I0 plateaus through
:func:`~repro_torch.core.engine.run_plateau_scan`, HA-SSA's storage policy
as per-plateau eligibility and one field contraction per cycle.
:func:`make_batched_iteration_step` runs the same chain over B stacked
problems, with the dense J, the tiled adjacency (``j_mode='tiled'``), the
XNOR-popcount planes (``field_mode='popcount'``) and packed spin words
across the step (``storage_layout='packed'``), per problem equal to the
single step.  Both run on the device their inputs live on, launch no CUDA
kernel of ``repro_torch.kernels`` and make no host sync.

On a mesh (:func:`repro_torch.launch.mesh.make_mesh`, axes ``data`` and
``model``; a :class:`~repro_torch.sharding.SpinMesh` is a mesh of one
``model`` axis) the steps run SPMD: each rank passes its own block of
every argument and gets its own block back, the JAX package's
``in_shardings`` (:func:`iteration_specs`; ``convert.iteration_state_block``
cuts a rank's blocks out of whole arrays and ``iteration_state_join`` puts
them back together).  Trials, or problems, split over ``data`` with no
collective.  The ``model`` axis is the spin sharding of
:class:`BatchedSpinShardedBackend` and reuses its collectives:

* dense J: rank (·, j) holds its spins' columns of every leaf and the
  coupling rows of its spins, Jᵀ's row slab (J's own for the symmetric J
  of an Ising model).  Each cycle it all-gathers the spins and contracts
  them against the slab: it gathers int8 spins, or 32-bit words where its
  block is whole words, where the JAX package lets GSPMD all-reduce
  float32 partial fields.  Both give the same integers (every float32 sum
  is of integers below 2^24); the gather moves 4× to 32× fewer bytes.  A
  fold all-reduces the per-shard energy sums before the floor division.
* tiled adjacency and popcount planes: the spins are replicated over
  ``model`` inside the step and the loop has no collective (the JAX
  package's own caveat): the model-sharded leaves are gathered once on
  entry and each rank keeps its own columns on exit.
* packed words are replicated over ``model`` (the JAX package's layout).

A dim that its axis does not divide is padded, as a GSPMD shard is: a
rank's block is ceil(dim / ranks) long, the pad spins carry zero
couplings and fields (so they enter no live field and no energy), pad
trials and problems are independent of the live ones, and the join drops
every pad.  :func:`anneal_step_lowering` and
:func:`batched_anneal_step_lowering` trace one rank's step on fake tensors
(:mod:`repro_torch.core.lowering`) at any mesh, the production 16 × 16
included.

The problem-partitioned backends keep the whole spin axis of a problem on
one device and scale out over the problem batch; a single giant instance
(100k+ spins) needs the spin axis itself split.  These backends run the
plateau engine (:func:`~repro_torch.core.engine.run_plateau_scan`,
unchanged) on every rank of a :class:`~repro_torch.sharding.SpinMesh`, SPMD:

* state shards: rank r owns spins [r·Ns, (r+1)·Ns) of every trial — its
  itanh, its xorshift lanes (seeded for its columns alone by
  :func:`~repro_torch.core.engine.padded_noise_init_slice`, equal to the
  single-device stream) and its best-m columns.  best_H is the same on
  every rank: it is folded from all-reduced energies.
* J by rows: the float32 tiled slabs and the XNOR-popcount bitplanes are
  both row-rectangular contractions, so each rank holds only its Ns rows,
  as padded adjacency or as bitplanes; its J bytes fall with the rank count.
* one collective per cycle: the update m(t) → m(t+1) needs every spin on
  every rank.  Spins are ±1, so the all-gather moves packed 32-bit words,
  N/32 per (problem, trial) — 8× below int8 spins.
* energy: a fold or a trace all-reduces the per-shard partial sums before
  the floor division (a shard's h·m + m·field may be odd; int32 addition is
  exact and order-free, so the sharded H equals the unsharded one).

A shard that is not a whole number of 32-bit words (Ns % 32 != 0) gathers
its int8 spins instead, and in the packed layout its (small) spin words
stay whole on every rank, each rank taking its columns after the unpack.

Every result equals the single-device run on live lanes.  The resident
CUDA kernels are single-device programs, so ``base_backend='cuda'`` runs
its arithmetic through these loops, as the JAX package's 'pallas' does
under spin sharding: no kernel is launched on this path.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.bitplane import PackedJ, pack_couplings_from_adjacency, pack_spins, unpack_spins
from ..sharding import (AbstractMesh, Mesh, SpinMesh, all_gather_last, all_reduce,
                        mesh_axis_rank, mesh_axis_size, spin_mesh)
from .engine import (
    BIG_ENERGY,
    BatchedBackend,
    EngineState,
    PackedEngineState,
    Plateau,
    PlateauBackend,
    POPCOUNT_TILE_N,
    TILED_J_THRESHOLD,
    exact_float32_matmul,
    pad_degree,
    pad_model,
    padded_noise_init_slice,
    resolve_backend,
    resolve_device,
    resolve_field_mode,
    run_plateau_scan,
    schedule_plateaus,
)
from .ising import local_fields_dense, local_fields_popcount, local_fields_tiled
from .rng import xorshift_next_bits

__all__ = ["make_iteration_step", "make_batched_iteration_step", "anneal_step_lowering",
           "batched_anneal_step_lowering", "iteration_specs", "SPIN_AXIS", "DATA_AXIS",
           "BatchedSpinShardedBackend", "SpinShardedBackend"]

# The mesh-axis names the spin axis and the trials (or problems) shard over.
SPIN_AXIS = "model"
DATA_AXIS = "data"


# ---------------------------------------------------------------------------
# The spin axis's collectives, shared by the meshed steps and the
# spin-sharded backends
# ---------------------------------------------------------------------------
def _gather_words(mesh, m_local, axis=None):
    """This rank's spins → every spin of the axis as packed words (the
    collective): words move where the block is whole words, int8 spins
    otherwise."""
    if m_local.shape[-1] % 32 == 0:
        return all_gather_last(mesh, pack_spins(m_local), axis)
    return pack_spins(all_gather_last(mesh, m_local, axis))


def _gather_spins(mesh, m_local, axis=None):
    """This rank's spins → every spin of the axis as int8, moved packed
    where the block is whole words."""
    if m_local.shape[-1] % 32 == 0:
        words = _gather_words(mesh, m_local, axis)
        return unpack_spins(words, 32 * words.shape[-1])
    return all_gather_last(mesh, m_local, axis)


def _sharded_energy(mesh, m, field, h, axis=None):
    """energy_from_field with the trial sums all-reduced over the axis's
    ranks before the floor division."""
    m32 = m.to(torch.int32)
    s = (h * m32).sum(dim=-1, dtype=torch.int32) + (m32 * field).sum(dim=-1, dtype=torch.int32)
    return -all_reduce(mesh, s, axis=axis) // 2


# ---------------------------------------------------------------------------
# The fused iteration steps
# ---------------------------------------------------------------------------
def iteration_specs(batched: bool = False, *, storage_layout: str = "dense",
                    j_mode: str = "dense", field_mode: str = "dense"):
    """((name, spec), ...) of the step's arguments in order: the mesh axis
    (or None) of each dim, the JAX package's ``in_shardings``
    (``anneal_step_lowering`` and ``batched_anneal_step_lowering``)."""
    d, p = DATA_AXIS, SPIN_AXIS
    if not batched:
        return (("rng", (None, d, p)), ("m", (d, p)), ("itanh", (d, p)), ("best_H", (d,)),
                ("best_m", (d, p)), ("J", (p, None)), ("h", (None,)))
    spins = (d, None, None) if storage_layout == "packed" else (d, None, p)
    state = (("rng", (None, d, None, p)), ("m", spins), ("itanh", (d, None, p)),
             ("best_H", (d, None)), ("best_m", spins))
    if field_mode == "popcount":
        problem = (("sign", (d, None, None)), ("mags", (d, None, None, None)),
                   ("base", (d, None)))
    elif j_mode == "tiled":
        problem = (("nbr_idx", (d, None, None)), ("nbr_w", (d, None, None)))
    else:
        problem = (("J", (d, p, None)),)
    return state + problem + (("h", (d, None)),)


def _check_mesh(mesh):
    if not isinstance(mesh, (Mesh, AbstractMesh, SpinMesh)):
        raise TypeError(f"mesh must be a repro_torch.sharding Mesh, AbstractMesh or SpinMesh "
                        f"(repro_torch.launch.mesh.make_mesh), got {type(mesh).__name__}")


def _own_columns(a, ranks: int, j: int, n_loc: int, value=0):
    """Rank j's block of the last axis, padded with ``value`` to ranks·n_loc."""
    pad = ranks * n_loc - a.shape[-1]
    if pad:
        a = torch.nn.functional.pad(a, (0, pad), value=value)
    return a[..., j * n_loc:(j + 1) * n_loc]


def _run_iteration(plateaus, field_fn, h, n_rnd: int, state: EngineState,
                   energy_fn=None) -> EngineState:
    """One iteration's plateau chain, xorshift noise, no traces."""
    for p in plateaus:
        state, _, _ = run_plateau_scan(field_fn, xorshift_next_bits, h, n_rnd, state, p.i0,
                                       length=p.length, eligible=p.eligible,
                                       energy_fn=energy_fn)
    return state


def make_iteration_step(hp, mesh=None):
    """One full I0min→I0max iteration, HA-SSA's storage policy fused.

    step(rng (4, T, N) int32 lanes, m (T, N) float32, itanh (T, N) int32,
         best_H (T,) int32, best_m (T, N) int8, J (N, N) float32,
         h (N,) int32) → (rng, m, itanh, best_H, best_m)

    The field is ``h + m @ J`` in float32 with TF32 off
    (:func:`~repro_torch.core.engine.exact_float32_matmul`), exact below
    2^24.  On a ``mesh`` every argument is this rank's block, placed as
    :func:`iteration_specs` says (J's block: the coupling rows of the
    rank's spins), and so is every result.
    """
    plateaus = schedule_plateaus(hp.schedule("hassa"), "i0max")
    n_rnd = hp.n_rnd
    exact_float32_matmul()
    if mesh is None:
        def step(rng, m, itanh, best_H, best_m, J, h):
            st = _run_iteration(plateaus, lambda m8: local_fields_dense(m8, h, J), h, n_rnd,
                                EngineState(rng, m.to(torch.int8), itanh, best_H, best_m))
            return st.noise_state, st.m.to(torch.float32), st.itanh, st.best_H, st.best_m

        return step
    _check_mesh(mesh)
    ranks, j = mesh_axis_size(mesh, SPIN_AXIS), mesh_axis_rank(mesh, SPIN_AXIS)

    energy = functools.partial(_sharded_energy, mesh, axis=SPIN_AXIS)

    def mesh_step(rng, m, itanh, best_H, best_m, J, h):
        n = h.shape[-1]
        h_own = _own_columns(h, ranks, j, itanh.shape[-1])
        J_cols = J.transpose(-1, -2)  # (N, n_loc): J's columns of this rank's spins

        def field_fn(m8):
            return local_fields_dense(_gather_spins(mesh, m8, SPIN_AXIS)[..., :n], h_own, J_cols)

        st = _run_iteration(plateaus, field_fn, h_own, n_rnd,
                            EngineState(rng, m.to(torch.int8), itanh, best_H, best_m), energy)
        return st.noise_state, st.m.to(torch.float32), st.itanh, st.best_H, st.best_m

    return mesh_step


def make_batched_iteration_step(hp, mesh=None, *, storage_layout: str = "dense",
                                j_mode: str = "dense", tile_n: int = POPCOUNT_TILE_N,
                                field_mode: str = "dense"):
    """One full iteration over B stacked (bucket-padded) problems; per
    problem equal to :func:`make_iteration_step`.

    Default (dense layout, dense J):
      step(rng (4, B, T, N) int32, m (B, T, N) float32, itanh (B, T, N) int32,
           best_H (B, T) int32, best_m (B, T, N) int8, J (B, N, N) float32,
           h (B, N) int32) → (rng, m, itanh, best_H, best_m)

    ``storage_layout='packed'`` carries m and best_m across the step as
    (B, T, ceil(N/32)) int32 words.  ``j_mode='tiled'`` takes ``nbr_idx,
    nbr_w (B, N, D) int32, h`` in place of ``J, h`` and streams (tile_n, N)
    float32 slabs per problem: no (B, N, N) buffer.  ``field_mode=
    'popcount'`` (it takes precedence over ``j_mode``) takes the stacked
    coupling planes ``sign (B, N, Nw), mags (B, nb, N, Nw), base (B, N),
    h`` and contracts by XNOR-popcount, row-tiled at ``tile_n`` so that the
    XNOR buffer stays (B, T, tile_n, Nw).  Every form gives the same numbers.
    On a ``mesh`` every argument and result is this rank's block, placed as
    :func:`iteration_specs` says.
    """
    if storage_layout not in ("dense", "packed"):
        raise ValueError(f"unknown storage_layout {storage_layout!r}")
    if j_mode not in ("dense", "tiled"):
        raise ValueError(f"unknown j_mode {j_mode!r}")
    if field_mode not in ("dense", "popcount"):
        raise ValueError(f"unknown field_mode {field_mode!r}")
    if mesh is not None:
        _check_mesh(mesh)
    plateaus = schedule_plateaus(hp.schedule("hassa"), "i0max")
    n_rnd, tile_n = hp.n_rnd, int(tile_n)
    packed = storage_layout == "packed"
    if field_mode == "dense":
        exact_float32_matmul()

    def whole_field_fn(problem):
        """The field of whole-width spins from whole-width operands."""
        h3 = problem[-1][:, None]  # (B, 1, N): broadcasts against (B, T, N) spins
        if field_mode == "popcount":
            pj = PackedJ(*(a[:, None] for a in problem[:3]))
            return lambda m8: local_fields_popcount(pack_spins(m8), h3, pj, tile_n=tile_n)
        if j_mode == "tiled":
            nbr_idx, nbr_w, _ = problem
            return lambda m8: local_fields_tiled(m8, h3, nbr_idx, nbr_w, tile_n=tile_n)
        return lambda m8: local_fields_dense(m8, h3, problem[0])

    def step(rng, m, itanh, best_H, best_m, *problem):
        n = itanh.shape[-1]
        if packed:
            m8, bm8 = unpack_spins(m, n), unpack_spins(best_m, n)
        else:
            m8, bm8 = m.to(torch.int8), best_m
        st = _run_iteration(plateaus, whole_field_fn(problem), problem[-1][:, None], n_rnd,
                            EngineState(rng, m8, itanh, best_H, bm8))
        if packed:
            return st.noise_state, pack_spins(st.m), st.itanh, st.best_H, pack_spins(st.best_m)
        return st.noise_state, st.m.to(torch.float32), st.itanh, st.best_H, st.best_m

    if mesh is None:
        return step
    ranks, j = mesh_axis_size(mesh, SPIN_AXIS), mesh_axis_rank(mesh, SPIN_AXIS)

    def whole(a, n):
        """Every column of a model-sharded leaf, live ones only."""
        return all_gather_last(mesh, a, SPIN_AXIS)[..., :n]

    def replicated_step(rng, m, itanh, best_H, best_m, *problem):
        """Tiled and popcount: the spins whole on every rank of ``model``,
        gathered on entry; no collective in the loop."""
        n, n_loc = problem[-1].shape[-1], itanh.shape[-1]
        if not packed:
            m, best_m = whole(m, n), whole(best_m, n)
        out = step(whole(rng, n), m, whole(itanh, n), best_H, best_m, *problem)
        own = lambda a: _own_columns(a, ranks, j, n_loc)  # noqa: E731
        if packed:
            return own(out[0]), out[1], own(out[2]), out[3], out[4]
        return own(out[0]), own(out[1]), own(out[2]), out[3], own(out[4])

    energy = functools.partial(_sharded_energy, mesh, axis=SPIN_AXIS)

    def sharded_step(rng, m, itanh, best_H, best_m, J, h):
        """Dense J: the spins over ``model``, gathered each cycle."""
        n, n_loc = h.shape[-1], itanh.shape[-1]
        h3 = _own_columns(h, ranks, j, n_loc)[:, None]
        J_cols = J.transpose(-1, -2)  # (B, N, n_loc)

        def field_fn(m8):
            return local_fields_dense(_gather_spins(mesh, m8, SPIN_AXIS)[..., :n], h3, J_cols)

        if packed:
            m8 = _own_columns(unpack_spins(m, n), ranks, j, n_loc, value=1)
            bm8 = _own_columns(unpack_spins(best_m, n), ranks, j, n_loc, value=1)
        else:
            m8, bm8 = m.to(torch.int8), best_m
        st = _run_iteration(plateaus, field_fn, h3, n_rnd,
                            EngineState(rng, m8, itanh, best_H, bm8), energy)
        if packed:
            return (st.noise_state, pack_spins(_gather_spins(mesh, st.m, SPIN_AXIS)[..., :n]),
                    st.itanh, st.best_H,
                    pack_spins(_gather_spins(mesh, st.best_m, SPIN_AXIS)[..., :n]))
        return st.noise_state, st.m.to(torch.float32), st.itanh, st.best_H, st.best_m

    if field_mode == "popcount" or j_mode == "tiled":
        return replicated_step
    return sharded_step


def _arg_infos(specs, shapes, dtypes, mesh):
    from .lowering import ArgInfo, block_shape

    return tuple(ArgInfo(name, tuple(shape), dtype, spec, block_shape(shape, spec, mesh))
                 for (name, spec), shape, dtype in zip(specs, shapes, dtypes))


def anneal_step_lowering(mesh, n_spins: int = 2000, n_trials: int = 4096, hp=None):
    """The dry-run lowering of :func:`make_iteration_step` on ``mesh``: rank
    0's step traced on fake tensors, nothing allocated, no collective
    issued (:func:`repro_torch.core.lowering.lower`).  ``mesh`` is a running
    mesh or an :func:`~repro_torch.sharding.abstract_mesh`, such as the
    production 16 × 16.  The JAX package's defaults and argument order."""
    from .lowering import lower
    from .ssa import SSAHyperParams

    hp = hp or SSAHyperParams(n_trials=n_trials)
    T, N = n_trials, n_spins
    i32, f32 = torch.int32, torch.float32
    shapes = ((4, T, N), (T, N), (T, N), (T,), (T, N), (N, N), (N,))
    dtypes = (i32, f32, i32, i32, torch.int8, f32, i32)
    return lower(lambda m: make_iteration_step(hp, m),
                 _arg_infos(iteration_specs(), shapes, dtypes, mesh), mesh)


def batched_anneal_step_lowering(mesh, n_problems: int = 8, n_spins: int = 2048,
                                 n_trials: int = 512, hp=None, *, storage_layout: str = "dense",
                                 j_mode: str = "dense", max_degree: int = 4,
                                 tile_n: int = POPCOUNT_TILE_N, field_mode: str = "dense",
                                 j_bits: int = 1):
    """The dry-run lowering of :func:`make_batched_iteration_step` on
    ``mesh``, as :func:`anneal_step_lowering`; the JAX package's defaults."""
    from .lowering import lower
    from .ssa import SSAHyperParams

    hp = hp or SSAHyperParams(n_trials=n_trials)
    B, T, N = n_problems, n_trials, n_spins
    nw = -(-N // 32)
    i32 = torch.int32
    spins = ((B, T, nw), i32, (B, T, nw), i32) if storage_layout == "packed" else \
        ((B, T, N), torch.float32, (B, T, N), torch.int8)
    shapes = [(4, B, T, N), spins[0], (B, T, N), (B, T), spins[2]]
    dtypes = [i32, spins[1], i32, i32, spins[3]]
    if field_mode == "popcount":
        shapes += [(B, N, nw), (B, j_bits, N, nw), (B, N)]
        dtypes += [i32, i32, i32]
    elif j_mode == "tiled":
        shapes += [(B, N, max_degree)] * 2
        dtypes += [i32, i32]
    else:
        shapes += [(B, N, N)]
        dtypes += [torch.float32]
    shapes.append((B, N))
    dtypes.append(i32)
    specs = iteration_specs(True, storage_layout=storage_layout, j_mode=j_mode,
                            field_mode=field_mode)
    return lower(lambda m: make_batched_iteration_step(
        hp, m, storage_layout=storage_layout, j_mode=j_mode, tile_n=tile_n,
        field_mode=field_mode), _arg_infos(specs, shapes, dtypes, mesh), mesh)


def _require_xorshift(noise: str):
    if noise != "xorshift":
        raise ValueError("partition='spin' requires noise='xorshift': shard-local lane "
                         "seeding is what makes sharded runs bit-identical")


def _mesh_for(mesh: Optional[SpinMesh], device) -> SpinMesh:
    """The given mesh (its device must be of the caller's kind) or a
    one-rank mesh on the caller's device."""
    if mesh is None:
        return spin_mesh(1, device=device)
    if device is not None and resolve_device(device).type != mesh.device.type:
        raise ValueError(f"device={device!r} differs from the mesh's device {mesh.device}")
    return mesh


class BatchedSpinShardedBackend(BatchedBackend):
    """B stacked problems with the spin axis sharded over a mesh's ranks.

    The serving path for instances too big for one device: the same
    bucket / stack / chunk protocol as every batched backend (so the
    service drives it unchanged), but :meth:`stack` builds this rank's row
    shard of the problem arrays and every plateau runs the engine's cycle
    loop on this rank's columns, with the collectives of
    :mod:`repro_torch.sharding`.  Equal per problem to the
    problem-partitioned backends on live lanes.

    ``base_backend`` picks the field contraction of the shards: 'sparse'
    gathers from the all-gathered spins through the padded adjacency;
    'dense' and 'cuda' take the float32 tiled-slab stream (``field_mode=
    'dense'``, with ``double_buffer`` slab prefetch) or the XNOR-popcount
    contraction (``field_mode='popcount'``; 'auto' picks it within
    POPCOUNT_AUTO_MAX_BITS planes).  The single-device knobs ``j_mode``,
    ``j_dtype``, ``block_r``, ``interpret`` and ``noise_mode`` are accepted
    and ignored, as in the JAX package, so the fallback chain can walk
    cuda → dense → sparse under spin sharding too.
    """

    name = "spinshard"

    def __init__(self, *, mesh: Optional[SpinMesh] = None, base_backend: str = "dense",
                 j_mode: str = "auto", tile_n: int = POPCOUNT_TILE_N, field_mode: str = "auto",
                 j_bits: int = 1, double_buffer: bool = True, j_dtype=None, block_r=None,
                 interpret=None, noise_mode=None, device=None, **kw):
        _require_xorshift(kw.get("noise", "xorshift"))
        del j_mode, j_dtype, block_r, interpret, noise_mode  # single-device knobs
        self.mesh = _mesh_for(mesh, device)
        super().__init__(device=self.mesh.device, **kw)
        self.n_dev = self.mesh.size
        if self.n_bucket % self.n_dev:
            raise ValueError(f"partition='spin': bucket {self.n_bucket} not divisible by "
                             f"the {self.n_dev} ranks of the mesh")
        self.n_shard = self.n_bucket // self.n_dev
        self.lo = self.mesh.rank * self.n_shard
        self.tile_n = int(tile_n)
        self.j_bits = int(j_bits)
        self.double_buffer = bool(double_buffer)
        base_backend = resolve_backend(base_backend, self.n_bucket)
        if base_backend not in ("sparse", "dense", "cuda"):
            raise ValueError(f"unknown base backend {base_backend!r}")
        if base_backend == "sparse":
            self.field_mode, self.field_style = "dense", "sparse"
        else:
            self.field_mode = resolve_field_mode(field_mode, self.j_bits)
            self.field_style = "popcount" if self.field_mode == "popcount" else "tiled"
        if self.field_style == "tiled":
            exact_float32_matmul()
        self.base_backend = base_backend
        # Row-tile the popcount contraction where the dense backend would
        # tile J, measured against the shard's rows, not the bucket's.
        self._pc_tile = None if self.n_shard <= TILED_J_THRESHOLD else self.tile_n
        # Spin words shard with the spins only where a shard is whole words.
        self._words_shardable = self.n_shard % 32 == 0

    # -- host side --------------------------------------------------------
    def stack(self, models) -> dict:
        """This rank's row shard of the stacked, bucket-padded problems:
        ``h`` and the padded adjacency rows (sparse, tiled) or the coupling
        bitplane rows (popcount), every column kept."""
        lo, hi = self.lo, self.lo + self.n_shard
        padded = [pad_model(m, self.n_bucket) for m in models]
        if self.field_style == "popcount":
            pjs = [pack_couplings_from_adjacency(p.n, p.nbr_idx, p.nbr_w, n_bits=self.j_bits,
                                                 device=self.device, rows=(lo, hi))
                   for p in padded]
            out = {k: torch.stack([getattr(pj, k) for pj in pjs])
                   for k in ("sign", "mags", "base")}
        else:
            d = max(p.max_degree for p in padded)
            padded = [pad_degree(p, d) for p in padded]
            out = {k: torch.as_tensor(np.stack([np.asarray(getattr(p, k))[lo:hi]
                                                for p in padded]),
                                      dtype=torch.int32, device=self.device)
                   for k in ("nbr_idx", "nbr_w")}
        out["h"] = torch.as_tensor(np.stack([np.asarray(p.h)[lo:hi] for p in padded]),
                                   dtype=torch.int32, device=self.device)
        return out

    def init_noise(self, seeds, n_lives):
        """This rank's columns of the stacked (B, 4, T, N) lanes, seeded for
        them alone: no rank ever holds the global lanes."""
        lo, hi = self.lo, self.lo + self.n_shard
        lanes = np.stack([padded_noise_init_slice(int(s), self.n_trials, int(nl),
                                                  self.n_bucket, lo, hi)
                          for s, nl in zip(seeds, n_lives)])
        return torch.from_numpy(np.ascontiguousarray(lanes).view(np.int32)).to(self.device)

    # -- the state's columns ----------------------------------------------
    def init_state(self, problem, noise0):
        """The random ±1 start of this rank's columns (best_H is whole)."""
        ns, r0 = self._noise_step(noise0)
        m0 = r0.to(torch.int8)
        itanh0 = torch.where(m0 > 0, 0, -1).to(torch.int32)
        best_H = torch.full(m0.shape[:-1], BIG_ENERGY, dtype=torch.int32, device=self.device)
        st = EngineState(ns.contiguous(), m0, itanh0, best_H, m0)
        return self._pack_local(st) if self.storage_layout == "packed" else st

    def _energy_local(self, m, field, h):
        return _sharded_energy(self.mesh, m, field, h)

    def _field_local(self, prob, m_local):
        """This rank's fields from its J rows and the all-gathered spins."""
        h = prob["h"][:, None]
        if self.field_style == "popcount":
            pj = PackedJ(*(prob[k][:, None] for k in ("sign", "mags", "base")))
            return local_fields_popcount(_gather_words(self.mesh, m_local), h, pj,
                                         tile_n=self._pc_tile)
        m_full = _gather_spins(self.mesh, m_local)
        if self.field_style == "sparse":
            B, T, _ = m_full.shape
            idx = prob["nbr_idx"]
            flat = idx.to(torch.int64).reshape(B, 1, -1).expand(B, T, -1)
            neigh = torch.gather(m_full.to(torch.int32), 2, flat).reshape(B, T, idx.shape[1], -1)
            return h + (prob["nbr_w"][:, None] * neigh).sum(dim=-1, dtype=torch.int32)
        return local_fields_tiled(m_full, h, prob["nbr_idx"], prob["nbr_w"],
                                  tile_n=self.tile_n, double_buffer=self.double_buffer)

    def _cols(self, full):
        """This rank's columns of a whole-width last axis."""
        return full[..., self.lo:self.lo + self.n_shard].contiguous()

    def _unpack_local(self, st: PackedEngineState) -> EngineState:
        if self._words_shardable:
            return EngineState(st.noise_state, unpack_spins(st.m_packed, self.n_shard),
                               st.itanh, st.best_H, unpack_spins(st.best_m_packed, self.n_shard))
        return EngineState(st.noise_state, self._cols(unpack_spins(st.m_packed, self.n_bucket)),
                           st.itanh, st.best_H,
                           self._cols(unpack_spins(st.best_m_packed, self.n_bucket)))

    def _pack_local(self, st: EngineState) -> PackedEngineState:
        if self._words_shardable:
            return PackedEngineState(st.noise_state, pack_spins(st.m), st.itanh, st.best_H,
                                     pack_spins(st.best_m))
        return PackedEngineState(st.noise_state, pack_spins(all_gather_last(self.mesh, st.m)),
                                 st.itanh, st.best_H,
                                 pack_spins(all_gather_last(self.mesh, st.best_m)))

    # -- the plateau loop -------------------------------------------------
    def _scan(self, prob, st: EngineState, p: Plateau, track_energy: bool = False):
        return run_plateau_scan(
            lambda m: self._field_local(prob, m), self._noise_step, prob["h"][:, None],
            self.n_rnd, st, p.i0, length=p.length, eligible=p.eligible,
            track_energy=track_energy, jperp=p.jperp, n_replicas=self.n_replicas,
            energy_fn=self._energy_local)

    def run_shots(self, problem, state, plateaus, n_shots):
        packed = self.storage_layout == "packed"
        st = self._unpack_local(state) if packed else state
        for _ in range(int(n_shots)):
            for p in plateaus:
                st, _, _ = self._scan(problem, st, p)
        return self._pack_local(st) if packed else st

    def run_plateau_traced(self, problem, state, plateau: Plateau, track_energy: bool):
        """One plateau with energy traces (the track_energy driver path)."""
        packed = self.storage_layout == "packed"
        st = self._unpack_local(state) if packed else state
        st, trace, _ = self._scan(problem, st, plateau, track_energy)
        return (self._pack_local(st) if packed else st), trace

    def finalize(self, state):
        """(best_H (B, T), best_m (B, T, N) int8), whole on every rank."""
        if self.storage_layout == "packed":
            words = state.best_m_packed
            if self._words_shardable:
                words = all_gather_last(self.mesh, words)
            return state.best_H, unpack_spins(words, self.n_bucket)
        return state.best_H, all_gather_last(self.mesh, state.best_m)

    # -- checkpoints: whole arrays, written by rank 0 ---------------------
    @property
    def writes_checkpoints(self) -> bool:
        return self.mesh.rank == 0

    def checkpoint_state(self, state):
        """The whole-width state (every rank gathers its shards)."""
        gather = lambda a: all_gather_last(self.mesh, a)  # noqa: E731
        if self.storage_layout == "packed":
            words = gather if self._words_shardable else (lambda a: a)
            return PackedEngineState(gather(state.noise_state), words(state.m_packed),
                                     gather(state.itanh), state.best_H,
                                     words(state.best_m_packed))
        return EngineState(gather(state.noise_state), gather(state.m), gather(state.itanh),
                           state.best_H, gather(state.best_m))

    def restore_state(self, tree):
        """This rank's columns of a whole-width state."""
        if self.storage_layout == "packed":
            if self._words_shardable:
                w0, w1 = self.lo // 32, (self.lo + self.n_shard) // 32
                words = lambda a: a[..., w0:w1].contiguous()  # noqa: E731
            else:
                words = lambda a: a  # noqa: E731
            return PackedEngineState(self._cols(tree.noise_state), words(tree.m_packed),
                                     self._cols(tree.itanh), tree.best_H,
                                     words(tree.best_m_packed))
        return EngineState(self._cols(tree.noise_state), self._cols(tree.m),
                           self._cols(tree.itanh), tree.best_H, self._cols(tree.best_m))

    def sync(self) -> None:
        self.mesh.barrier()

    def rank_span(self, value: int) -> Tuple[int, int]:
        """(min, max) of ``value`` over the ranks: one all-reduce of (-v, v)
        under max.  A spin group resumes only from a checkpoint that every
        rank sees and accepts, so that all ranks issue the same collectives."""
        neg_lo, hi = all_reduce(self.mesh, torch.tensor([-value, value], dtype=torch.int64,
                                                        device=self.mesh.device), "max").tolist()
        return -neg_lo, hi


class SpinShardedBackend(PlateauBackend):
    """Single-problem spin-sharded backend (the ``anneal()`` driver path).

    Wraps a B = 1 :class:`BatchedSpinShardedBackend`: the model is padded to
    a multiple of the rank count (the live lanes evolve as unpadded, the
    pad columns are inert), its row shard is built at construction, and
    every plateau runs the shard's cycle loop with its collectives.
    ``record='traj'`` (trajectory planes) is not supported on this path:
    use partition='problem' for trajectory studies.
    """

    name = "spinshard"

    def __init__(self, model, *, n_trials: int, n_rnd: int = 2, noise: str = "xorshift",
                 storage_layout: str = "dense", mesh: Optional[SpinMesh] = None,
                 device=None, n_replicas: int = 0, **opts):
        _require_xorshift(noise)
        mesh = _mesh_for(mesh, device)
        super().__init__(model, n_trials=n_trials, n_rnd=n_rnd, noise=noise,
                         storage_layout=storage_layout, n_replicas=n_replicas,
                         device=mesh.device)
        self._bk = BatchedSpinShardedBackend(
            mesh=mesh, n_bucket=-(-model.n // mesh.size) * mesh.size, n_trials=n_trials,
            n_rnd=n_rnd, noise=noise, storage_layout=storage_layout, n_replicas=n_replicas,
            **opts)
        self.mesh = mesh
        self._problem = self._bk.stack([model])

    def init_state(self, seed: int):
        return self._bk.init_state(self._problem, self._bk.init_noise([seed], [self.model.n]))

    def run_plateau(self, state, i0, *, length, eligible, track_energy=False, emit=False,
                    jperp=0):
        if emit:
            raise NotImplementedError("record='traj' is not supported under partition='spin'; "
                                      "use partition='problem' for trajectory capture")
        p = Plateau(int(i0), int(length), bool(eligible), int(jperp))
        if track_energy:
            st, trace = self._bk.run_plateau_traced(self._problem, state, p, True)
            return st, trace, None
        return self._bk.run_shots(self._problem, state, (p,), 1), None, None

    def run_plateaus(self, state, plateaus):
        return self._bk.run_shots(self._problem, state, tuple(plateaus), 1)

    def finalize(self, state):
        best_H, best_m = self._bk.finalize(state)
        return best_H[0], best_m[0, :, : self.model.n]
