"""The meshes: ``torch.distributed`` process groups run SPMD, and the LM's
logical-axis rules (port of ``repro.sharding``).

Every parameter and activation of the LM carries *logical* axis names; a
rule table maps them to mesh axes.  :func:`logical_to_spec` is the JAX
package's: divisibility-aware (a dim its axes do not divide stays whole),
each mesh axis used at most once, first come first served, trimmed from
the right.  A spec is a tuple with one entry per dim — a mesh axis name, a
tuple of names, or None — trailing Nones trimmed, the entries of the JAX
package's ``PartitionSpec``.  The LM's per-rank serving program
(``repro_torch.models``) places every block by it; torch has no sharding
propagation, so :func:`constrain` moves nothing.

The JAX package shards the spin axis of one instance over a 1-D
``jax.sharding.Mesh`` driven from one process.  Here the mesh is a process
group and every rank runs the same call, as ``torchrun`` runs it: rank r
owns the columns ``[r·Ns, (r+1)·Ns)`` of every spin-sharded array, and the
few collectives below move what crosses ranks.

Backends: NCCL on the card (rank r on ``cuda:r``), gloo on the CPU.  P > 1
gloo ranks may share one card: the collectives then copy each operand to
host memory and back, explicitly, because gloo is the backend the group
was made with.  At P = 1 every collective is still issued.

:func:`spin_mesh` (a 1-D :class:`SpinMesh`) and
:func:`repro_torch.launch.mesh.make_mesh` (an N-D :class:`Mesh`, such as
the annealer's ``data`` × ``model`` grid) are the public ways to reach a
group.  Without a default process group and with one rank asked for, each
makes a one-rank group (NCCL on ``cuda``, gloo on ``cpu``) from an
in-process ``HashStore``; a group of several ranks is joined beforehand —
by ``torchrun`` (see :func:`repro_torch.launch.mesh.make_spin_mesh`) or by
``torch.distributed.init_process_group`` with a ``file://`` rendezvous.
:func:`abstract_mesh` is a mesh's shape alone: the dry-run lowerings take
it to analyse one rank of a mesh that is not running, and it issues no
collective.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Axes",
    "ShardingRules",
    "DEFAULT_RULES",
    "SERVE_WEIGHT_STATIONARY_RULES",
    "TRAIN_FSDP_SP_RULES",
    "logical_to_spec",
    "NamedSharding",
    "named_sharding",
    "constrain",
    "require_default_rules",
    "unported_on_mesh",
    "SpinMesh",
    "spin_mesh",
    "Mesh",
    "AbstractMesh",
    "abstract_mesh",
    "mesh_fingerprint",
    "mesh_axis_size",
    "mesh_axis_rank",
    "mesh_coords",
    "axis_groups",
    "axis_index",
    "all_gather",
    "all_gather_last",
    "all_reduce",
    "all_to_all",
    "reduce_from",
    "copy_to",
    "gather_from",
    "unshard",
    "block",
    "batch_axes",
    "mark_phase",
    "max_over_ranks",
    "collective_counts",
    "reset_collective_counts",
]

Axes = Tuple[Optional[str], ...]  # logical names per dim (None = replicated)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis name → mesh axis (str) or tuple of mesh axes: the JAX
    package's rule table for the LM stack."""

    rules: Tuple[Tuple[str, Any], ...] = (
        ("batch", ("pod", "data")),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("d_ff", "model"),
        ("experts", "model"),
        ("vocab", "model"),
        ("kv_seq", "model"),
        ("ssm_state", None),
        ("d_model", None),
        ("seq", None),
        ("d_head", None),
        ("layers", None),
    )

    def lookup(self, logical: Optional[str]):
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def replace(self, **kw) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(rules=tuple(d.items()))


DEFAULT_RULES = ShardingRules()

# The JAX package's rule presets.  Weight-stationary serving: the data axis
# also shards the weights' d_model and long KV spreads over every free
# axis.  Megatron-SP + FSDP training: the residual stream's sequence over
# model, the weights' d_model over data.  Their specs are computed here;
# the serving program executes DEFAULT_RULES only.
SERVE_WEIGHT_STATIONARY_RULES = DEFAULT_RULES.replace(
    d_model=("data",),
    kv_seq=("model", "data"),
)
TRAIN_FSDP_SP_RULES = DEFAULT_RULES.replace(
    d_model=("data",),
    seq=("model",),
)


def _present(mesh, axis):
    """An axis spec filtered down to the axes the mesh has."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in mesh.shape)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axis if axis in mesh.shape else None


def logical_to_spec(mesh, shape: Sequence[int], axes: Axes,
                    rules: ShardingRules = DEFAULT_RULES) -> tuple:
    """The placement of an array of ``shape`` whose dims carry the logical
    ``axes``: one entry per dim (a mesh axis, a tuple of them, or None),
    trailing Nones trimmed.  An assignment that does not divide its dim is
    trimmed from the right until it does (or dropped); a mesh axis is used
    at most once, first come first served in dim order."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} rank != shape {shape}")
    used = set()
    out = []
    for dim, logical in zip(shape, axes):
        axis = _present(mesh, rules.lookup(logical))
        if axis is None:
            out.append(None)
            continue
        parts = [a for a in (list(axis) if isinstance(axis, tuple) else [axis]) if a not in used]
        while parts and (mesh_axis_size(mesh, tuple(parts)) <= 1
                         or dim % mesh_axis_size(mesh, tuple(parts)) != 0):
            parts.pop()
        if not parts:
            out.append(None)
            continue
        used.update(parts)
        out.append(tuple(parts) if len(parts) > 1 else parts[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (:func:`logical_to_spec`'s form): the JAX
    package's ``NamedSharding``."""

    mesh: Any
    spec: tuple


def named_sharding(mesh, shape: Sequence[int], axes: Axes,
                   rules: ShardingRules = DEFAULT_RULES) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(mesh, shape, axes, rules))


_STEP10 = "ROADMAP.md queue 1, step 10"


def require_default_rules(rules: ShardingRules, what: str) -> None:
    """A mesh executes DEFAULT_RULES only: any other table on a mesh raises
    NotImplementedError (step 10.5)."""
    if rules != DEFAULT_RULES:
        raise NotImplementedError(
            f"{what}: a mesh executes DEFAULT_RULES only; other rule tables "
            f"(SERVE_WEIGHT_STATIONARY_RULES, TRAIN_FSDP_SP_RULES) are {_STEP10}.5, "
            "not ported yet")


def unported_on_mesh(mesh, what: str, step: str = "") -> None:
    """Raise NotImplementedError citing step 10 (its sub-step ``step``, such
    as ``".2"``) for a path that runs on one device only (``what`` names
    it), when it is given a mesh."""
    if mesh is not None:
        raise NotImplementedError(f"{what} on a mesh is {_STEP10}{step}, not ported yet")


def constrain(x, mesh, axes, rules: ShardingRules = DEFAULT_RULES):
    """The LM path's sharding constraint by logical axes: ``x`` itself.

    Without a mesh nothing is placed.  On a mesh ``x`` is this rank's block
    and the per-rank program has already placed it (the layers cut heads,
    d_ff and vocab by :func:`logical_to_spec` and issue their collectives
    themselves), so nothing moves; a rule table other than DEFAULT_RULES
    raises NotImplementedError."""
    if mesh is not None:
        require_default_rules(rules, "constrain")
    return x


# Collectives issued since the last reset, by kind: the spin path's
# per-cycle traffic is read from here.
collective_counts: collections.Counter = collections.Counter()


def reset_collective_counts() -> None:
    collective_counts.clear()


@dataclasses.dataclass(frozen=True, eq=False)
class SpinMesh:
    """A 1-D mesh of ``size`` ranks over one named axis.

    ``rank`` is this process's place on the axis, ``device`` the device its
    shards live on, ``backend`` the group's ('nccl' or 'gloo').  The group is
    the default process group, looked up at each collective: a mesh holds
    no reference to it, so ``destroy_process_group()`` frees it at once
    rather than at interpreter exit.  Equality is identity: two meshes over
    the same ranks are the same layout, which :func:`mesh_fingerprint`
    states."""

    axis: str
    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    def barrier(self) -> None:
        dist.barrier()


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def _requested_device(what: str, device) -> torch.device:
    """``cuda`` unless the caller passes another device; no fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: a CUDA device was requested but "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    return dev


def _join_one_rank(dev: torch.device) -> None:
    """A one-rank default group on an in-process store: NCCL on the card,
    gloo on the CPU."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _rank_device(what: str, dev: torch.device) -> Tuple[str, torch.device]:
    """(the running group's backend, the device this rank's shards live on).
    An NCCL group with more ranks than GPUs raises ValueError naming both,
    and so does a running one-rank gloo group asked for on the card."""
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"{what}: an NCCL group runs on the card; pass "
                             "device='cuda' or join a gloo group for the CPU")
        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"{what}: an NCCL group of {world} ranks needs "
                             f"{world} GPUs, {have} exist; use gloo ranks to share one")
        dev = torch.device("cuda", _local_rank(rank))
    elif dev.type == "cuda":
        if world == 1:
            raise ValueError(
                f"{what}: a one-rank mesh on the card is an NCCL group, but a "
                f"{backend} group is running; call torch.distributed.destroy_process_group() "
                "first, or pass device='cpu'")
        dev = torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())
    return backend, dev


def spin_mesh(n: Optional[int] = None, *, axis: str = "model", device=None) -> SpinMesh:
    """The 1-D spin mesh over ``n`` ranks (None: every rank of the group).

    ``device`` is ``cuda`` unless the caller passes another (``'cpu'``).
    With a default process group of W ranks, ``n`` must be None or W: a
    spin mesh spans the whole group, each rank running the same program;
    more ranks than exist raises ValueError naming both counts.  Without
    one, ``n in (None, 1)`` makes a one-rank group on an in-process store.
    An NCCL group with more ranks than GPUs raises ValueError naming both,
    and so does a running one-rank gloo group asked for on the card.
    """
    dev = _requested_device("spin_mesh", device)
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f"spin_mesh: need 1 <= n <= 1 ranks, got {n}: no process group is "
                "running; start the ranks with torchrun (or join a group with "
                "torch.distributed.init_process_group) before asking for more")
        _join_one_rank(dev)
    world = dist.get_world_size()
    k = world if n is None else int(n)
    if not 1 <= k <= world:
        raise ValueError(f"spin_mesh: need 1 <= n <= {world} ranks, got {k}")
    if k != world:
        raise ValueError(
            f"spin_mesh: the process group has {world} ranks and a spin mesh spans "
            f"all of them; start {k} ranks to shard over {k}")
    backend, dev = _rank_device("spin_mesh", dev)
    return SpinMesh(axis=axis, size=world, rank=dist.get_rank(), device=dev, backend=backend)


class _Grid:
    """The shape of an N-D mesh: ``axis_names``, ``axis_sizes`` and this
    process's ``rank`` on it."""

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def coords(self) -> Tuple[int, ...]:
        return mesh_coords(self.axis_sizes, self.rank)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh(_Grid):
    """An N-D mesh over every rank of the running process group, such as the
    annealer's ``("data", "model")`` grid.

    Rank r sits at ``coords``, r unravelled row-major over ``axis_sizes``
    (the last axis varies fastest: with a ``model`` axis last, a model
    group is a run of consecutive ranks, one node's GPUs where it fits).
    ``groups[i]`` is the process group of the ranks that share every
    coordinate but axis i's, the group a collective over that axis runs
    in; None where the axis spans the whole group (the default group).
    ``device`` and ``backend`` are as :class:`SpinMesh`'s.  Build one with
    :func:`repro_torch.launch.mesh.make_mesh`."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Tuple[Any, ...]

    def barrier(self) -> None:
        dist.barrier()


def mesh_coords(axis_sizes: Sequence[int], rank: int) -> Tuple[int, ...]:
    """A rank's coordinates, unravelled row-major over ``axis_sizes``."""
    out = []
    for size in reversed(tuple(axis_sizes)):
        rank, c = divmod(rank, int(size))
        out.append(c)
    return tuple(reversed(out))


def axis_groups(axis_sizes: Sequence[int], rank: int) -> Tuple[Any, ...]:
    """The process group of each axis that holds ``rank`` (None where an axis
    spans every rank).  Every rank makes every group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    sizes = tuple(int(s) for s in axis_sizes)
    world = math.prod(sizes)
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    mine = []
    for i, size in enumerate(sizes):
        if size == world:
            mine.append(None)
            continue
        group = None
        for base in range(world):
            if mesh_coords(sizes, base)[i]:
                continue  # one group per line of the axis, from its coordinate 0
            ranks = [base + k * strides[i] for k in range(size)]
            g = dist.new_group(ranks)
            if rank in ranks:
                group = g
        mine.append(group)
    return tuple(mine)


@dataclasses.dataclass(frozen=True, eq=False)
class AbstractMesh(_Grid):
    """A mesh's shape alone: no process group, no device.  The dry-run
    lowerings (:func:`repro_torch.core.distributed.anneal_step_lowering`)
    take one to analyse rank 0 of a mesh that need not be running, such as
    the production 16 × 16.  It issues no collective: a lowering gives it a
    ``record`` hook that notes each collective and returns a fake result;
    without one, a collective raises RuntimeError.  A lowering's ``phase``
    hook takes the program's :func:`mark_phase` calls."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    record: Optional[Callable] = None
    rank: int = 0
    phase: Optional[Callable] = None


def mark_phase(mesh, label: str) -> None:
    """A phase of the program starts (``'group'`` before each layer group,
    ``'epilogue'`` after them): passed to the mesh's ``phase`` hook, which
    only a lowering's mesh has (the dry-run reads each phase's peak)."""
    hook = getattr(mesh, "phase", None)
    if hook is not None:
        hook(label)


def abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    """The shape-only mesh of ``axis_sizes`` over ``axis_names`` (the JAX
    package's ``abstract_mesh``, same argument order)."""
    sizes, names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"mesh shape {sizes} rank != axes {names}")
    return AbstractMesh(names, sizes)


def mesh_fingerprint(mesh) -> tuple:
    """Hashable mesh identity: the (axis, size) pairs and the ranks 0..P-1 —
    the JAX package's fingerprint of a mesh of P devices, so that equal
    options give equal ``SolverConfig.signature()`` digests in both
    packages."""
    if mesh is None:
        return ()
    return (tuple(mesh.shape.items()), tuple(range(mesh.size)))


def mesh_axis_size(mesh, axis="model") -> int:
    """Ranks on a mesh axis, or the product over a tuple of axes (1 for no
    mesh, no axis or an absent axis)."""
    if mesh is None or axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh_axis_size(mesh, a) for a in axis)
    return int(mesh.shape.get(axis, 1))


def mesh_axis_rank(mesh, axis: str = "model") -> int:
    """This rank's coordinate on a mesh axis (0 for an absent axis)."""
    if isinstance(mesh, SpinMesh):
        return mesh.rank if axis == mesh.axis else 0
    if axis not in mesh.axis_names:
        return 0
    return mesh.coords[mesh.axis_names.index(axis)]


def _axis_group(mesh, axis):
    """(ranks on the collective's axis, its process group): a spin mesh's
    one axis runs in the default group."""
    if isinstance(mesh, SpinMesh):
        return mesh.size, None
    i = mesh.axis_names.index(axis)
    return mesh.axis_sizes[i], (None if isinstance(mesh, AbstractMesh) else mesh.groups[i])


def _abstract(mesh: AbstractMesh, kind: str, axis: str, x: torch.Tensor, shape) -> torch.Tensor:
    if mesh.record is None:
        raise RuntimeError(f"an abstract mesh issues no collective ({kind} over {axis!r}); "
                           "lower the step instead of calling it")
    return mesh.record(kind, axis, x, tuple(shape))


def _to_wire(mesh: SpinMesh, x: torch.Tensor) -> torch.Tensor:
    """The operand as the group's backend takes it: gloo ranks sharing a card
    copy it to host memory."""
    x = x.contiguous()
    return x.cpu() if mesh.backend == "gloo" and x.device.type != "cpu" else x


# torch 2.13 names the dim-0 gather ``all_gather_single`` and deprecates
# ``all_gather_into_tensor``, the only name of earlier releases.
_gather_dim0 = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def axis_index(mesh, axes) -> int:
    """This rank's place along a mesh axis or a tuple of axes (row-major
    over the tuple, the first axis outermost: GSPMD's order of the blocks
    of a dim placed on several axes); 0 for None."""
    if axes is None:
        return 0
    idx = 0
    for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
        idx = idx * mesh_axis_size(mesh, a) + mesh_axis_rank(mesh, a)
    return idx


def all_gather(mesh, x: torch.Tensor, dim: int, axis: Optional[str] = None) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, rank-major over the
    mesh ``axis`` (a spin mesh's one axis when None).

    The collective concatenates along dim 0 (P·x.shape[0], ...); the rank
    blocks are then moved to ``dim``."""
    size, group = _axis_group(mesh, axis)
    shape = tuple(x.shape)
    dim = dim % len(shape)
    out_shape = shape[:dim] + (size * shape[dim],) + shape[dim + 1:]
    if isinstance(mesh, AbstractMesh):
        return _abstract(mesh, "all-gather", axis, x, out_shape)
    collective_counts["all_gather"] += 1
    src = _to_wire(mesh, x)
    out = torch.empty((size * shape[0],) + shape[1:], dtype=src.dtype, device=src.device)
    _gather_dim0(out, src, group=group)
    out = out.view((size,) + shape).movedim(0, dim).reshape(out_shape)
    return out.to(x.device)


def all_gather_last(mesh, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
    """:func:`all_gather` along the last axis, where the spin columns live."""
    return all_gather(mesh, x, -1, axis)


def all_to_all(mesh, x: torch.Tensor, split_dim: int, concat_dim: int,
               axis: Optional[str] = None) -> torch.Tensor:
    """Cut ``x`` into P equal blocks along ``split_dim`` and send block j to
    rank j of the mesh ``axis``; the blocks received are concatenated along
    ``concat_dim`` in rank order.  Such as a (B, S, K/P, D) cache cut by
    heads turned into the (B, S/P, K, D) cut by sequence."""
    size, group = _axis_group(mesh, axis)
    shape = list(x.shape)
    split_dim, concat_dim = split_dim % len(shape), concat_dim % len(shape)
    if shape[split_dim] % size:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(shape)} is not a multiple "
                         f"of the {size} ranks of {axis!r}")
    out_shape = list(shape)
    out_shape[split_dim] //= size
    out_shape[concat_dim] *= size
    if isinstance(mesh, AbstractMesh):
        return _abstract(mesh, "all-to-all", axis, x, tuple(out_shape))
    collective_counts["all_to_all"] += 1
    # (P, block...) with block j to go to rank j, contiguous
    blocks = x.unflatten(split_dim, (size, shape[split_dim] // size)).movedim(split_dim, 0)
    src = _to_wire(mesh, blocks)
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src, group=group)
    # recv[i] is rank i's block: move the rank index next to concat_dim
    recv = recv.to(x.device).movedim(0, concat_dim)
    return recv.flatten(concat_dim, concat_dim + 1)


def all_reduce(mesh, x: torch.Tensor, op: str = "sum", axis: Optional[str] = None) -> torch.Tensor:
    """Elementwise sum (or max) of ``x`` over the ranks of the mesh ``axis``
    (a spin mesh's one axis when None); a new tensor.  Integer sums are
    exact and order-free, so an int32 energy sum equals the unsharded one."""
    _, group = _axis_group(mesh, axis)
    if isinstance(mesh, AbstractMesh):
        return _abstract(mesh, "all-reduce", axis, x, x.shape)
    collective_counts["all_reduce"] += 1
    buf = _to_wire(mesh, x).clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return buf.to(x.device)


def _axes(axis) -> Tuple[str, ...]:
    """A mesh axis, a tuple of them or None as a tuple of names."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _sum_over(mesh, x: torch.Tensor, axis) -> torch.Tensor:
    """:func:`all_reduce` sums over each axis of ``axis`` in turn."""
    for a in _axes(axis):
        x = all_reduce(mesh, x, "sum", a)
    return x


class _ReduceFrom(torch.autograd.Function):
    """Sum over the axes in the forward pass; the identity in the backward
    pass (every rank holds the whole sum, and its cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum_over(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """The identity in the forward pass; in the backward pass the ranks'
    partial cotangents summed over the axes, in float32, rounded once to
    the cotangent's dtype."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(ctx.mesh, g.to(torch.float32), ctx.axis).to(g.dtype), None, None


class _GatherFrom(torch.autograd.Function):
    """:func:`all_gather` along ``dim`` in the forward pass; this rank's
    slice of the cotangent in the backward pass."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis, ctx.n = mesh, dim % x.dim(), axis, x.shape[dim]
        return all_gather(mesh, x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        lo = axis_index(ctx.mesh, ctx.axis) * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from(mesh, x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over the mesh ``axis`` (or each axis of a tuple in
    turn): the value of :func:`all_reduce`'s sum, and under autograd the
    identity on the way back.  It ends a region cut over ``axis`` (a
    row-parallel product, the vocab-parallel lookup, the loss's sums):
    every rank holds the whole result and the same cotangent of it."""
    if not _differentiable(x):
        return _sum_over(mesh, x, axis)
    return _ReduceFrom.apply(x, mesh, axis)


def copy_to(mesh, x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself where a tensor replicated over the mesh ``axis`` enters
    a region cut over it; under autograd its cotangent, partial on each
    rank, is summed over ``axis`` on the way back (in float32, rounded
    once).  None for ``axis``: ``x``."""
    if axis is None or not _differentiable(x):
        return x
    return _CopyTo.apply(x, mesh, axis)


def gather_from(mesh, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """:func:`all_gather` of ``x`` along ``dim``; under autograd each rank
    takes back its own slice of the cotangent."""
    if not _differentiable(x):
        return all_gather(mesh, x, dim, axis)
    return _GatherFrom.apply(x, mesh, dim, axis)


def unshard(mesh, x: torch.Tensor, spec) -> torch.Tensor:
    """The whole array of which ``x`` is this rank's block, placed by
    ``spec`` (:func:`logical_to_spec`'s form): all-gathered over each
    placed dim's axes, the last axis of a tuple first.  Collective: every
    rank of the mesh calls it with its own block."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if mesh_axis_size(mesh, a) > 1:
                x = all_gather(mesh, x, dim, a)
    return x


def block(mesh, x: torch.Tensor, spec, pad=None) -> torch.Tensor:
    """This rank's block of the whole array ``x`` placed by ``spec`` (a
    contiguous copy); the inverse of :func:`unshard`.  A placed dim that is
    not a multiple of its axes' ranks raises ValueError, or with ``pad`` is
    first padded with it to ranks × ceil(dim / ranks), as a GSPMD shard
    is."""
    for dim, entry in enumerate(spec):
        n = mesh_axis_size(mesh, entry)
        if n == 1:
            continue
        size = -(-x.shape[dim] // n)
        if size * n != x.shape[dim]:
            if pad is None:
                raise ValueError(f"block: dim {dim} of {tuple(x.shape)} is not a multiple of "
                                 f"the {n} ranks of {entry!r}")
            widths = [0, 0] * (x.dim() - dim - 1) + [0, size * n - x.shape[dim]]
            x = torch.nn.functional.pad(x, widths, value=pad)
        x = x.narrow(dim, axis_index(mesh, entry) * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def batch_axes(mesh, rules: ShardingRules = DEFAULT_RULES) -> Tuple[str, ...]:
    """The mesh axes the batch is cut over (DEFAULT_RULES: ``pod`` and
    ``data``, those the mesh has): the axes a training step sums its loss
    and gradients over.  A one-rank axis is kept: its sum is issued, and
    exact."""
    return tuple(a for a in _axes(rules.lookup("batch")) if a in mesh.shape)


def max_over_ranks(mesh: Optional[SpinMesh], values):
    """``values`` (floats) as the largest over the ranks, one all-reduce —
    unchanged without a mesh of several ranks.  The services read elapsed
    times through it, so that every rank takes the same time-based
    decision."""
    values = list(values)
    if not values or mesh is None or mesh.size == 1:
        return values
    return all_reduce(mesh, torch.tensor(values, dtype=torch.float64, device=mesh.device),
                      "max").tolist()
