"""The spin mesh: a ``torch.distributed`` process group, run SPMD (the spin
half of ``repro.sharding``); and the LM half's logical-axis rules, which
wait for a mesh (ROADMAP.md queue 1, step 10).

The JAX package shards the spin axis of one instance over a 1-D
``jax.sharding.Mesh`` driven from one process.  Here the mesh is a process
group and every rank runs the same call, as ``torchrun`` runs it: rank r
owns the columns ``[r·Ns, (r+1)·Ns)`` of every spin-sharded array, and the
few collectives below move what crosses ranks.

Backends: NCCL on the card (rank r on ``cuda:r``), gloo on the CPU.  P > 1
gloo ranks may share one card: the collectives then copy each operand to
host memory and back, explicitly, because gloo is the backend the group
was made with.  At P = 1 every collective is still issued.

:func:`spin_mesh` is the only public way to reach a group.  Without a
default process group and with ``n in (None, 1)`` it makes a one-rank group
(NCCL on ``cuda``, gloo on ``cpu``) from an in-process ``HashStore``; a
group of several ranks is joined beforehand — by ``torchrun`` (see
:func:`repro_torch.launch.mesh.make_spin_mesh`) or by
``torch.distributed.init_process_group`` with a ``file://`` rendezvous.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "constrain",
    "SpinMesh",
    "spin_mesh",
    "mesh_fingerprint",
    "mesh_axis_size",
    "all_gather_last",
    "all_reduce",
    "max_over_ranks",
    "collective_counts",
    "reset_collective_counts",
]

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis name → mesh axis (str) or tuple of mesh axes: the JAX
    package's rule table for the LM stack, kept as data.  Nothing reads it
    until the LM path takes a mesh."""

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


def constrain(x, mesh, axes, rules: ShardingRules = DEFAULT_RULES):
    """The LM path's sharding constraint by logical axes: ``x`` itself
    without a mesh.  Tensor-parallel LM serving over several GPUs is not
    ported: a mesh raises NotImplementedError."""
    if mesh is None:
        return x
    raise NotImplementedError(
        "the LM path runs on one device: a mesh (tensor-parallel LM serving) is "
        "ROADMAP.md queue 1, step 10, not ported yet")


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
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spin_mesh: a CUDA device was requested but "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(
                f"spin_mesh: need 1 <= n <= 1 ranks, got {n}: no process group is "
                "running; start the ranks with torchrun (or join a group with "
                "torch.distributed.init_process_group) before asking for more")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    rank = dist.get_rank()
    k = world if n is None else int(n)
    if not 1 <= k <= world:
        raise ValueError(f"spin_mesh: need 1 <= n <= {world} ranks, got {k}")
    if k != world:
        raise ValueError(
            f"spin_mesh: the process group has {world} ranks and a spin mesh spans "
            f"all of them; start {k} ranks to shard over {k}")
    backend = dist.get_backend()
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("spin_mesh: an NCCL group runs on the card; pass "
                             "device='cuda' or join a gloo group for the CPU")
        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"spin_mesh: an NCCL group of {world} ranks needs "
                             f"{world} GPUs, {have} exist; use gloo ranks to share one")
        dev = torch.device("cuda", _local_rank(rank))
    elif dev.type == "cuda":
        if world == 1:
            raise ValueError(
                "spin_mesh: a one-rank spin mesh on the card is an NCCL group, but a "
                f"{backend} group is running; call torch.distributed.destroy_process_group() "
                "first, or pass device='cpu'")
        dev = torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())
    return SpinMesh(axis=axis, size=world, rank=rank, device=dev, backend=backend)


def mesh_fingerprint(mesh: Optional[SpinMesh]) -> tuple:
    """Hashable mesh identity: ((axis, P),) and the ranks 0..P-1 — the JAX
    package's fingerprint of a P-device mesh, so that equal options give
    equal ``SolverConfig.signature()`` digests in both packages."""
    if mesh is None:
        return ()
    return (((mesh.axis, mesh.size),), tuple(range(mesh.size)))


def mesh_axis_size(mesh: Optional[SpinMesh], axis: str = "model") -> int:
    """Ranks on a mesh axis (1 for no mesh or an absent axis)."""
    return 1 if mesh is None else int(mesh.shape.get(axis, 1))


def _to_wire(mesh: SpinMesh, x: torch.Tensor) -> torch.Tensor:
    """The operand as the group's backend takes it: gloo ranks sharing a card
    copy it to host memory."""
    x = x.contiguous()
    return x.cpu() if mesh.backend == "gloo" and x.device.type != "cpu" else x


# torch 2.13 names the dim-0 gather ``all_gather_single`` and deprecates
# ``all_gather_into_tensor``, the only name of earlier releases.
_gather_dim0 = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_last(mesh: SpinMesh, x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's ``x`` along its last axis, rank-major.

    The collective concatenates along dim 0 (P·x.shape[0], ...); the rank
    blocks are moved to the last axis, where the spin columns live."""
    collective_counts["all_gather"] += 1
    src = _to_wire(mesh, x)
    shape = tuple(src.shape)
    out = torch.empty((mesh.size * shape[0],) + shape[1:], dtype=src.dtype, device=src.device)
    _gather_dim0(out, src)
    out = out.view((mesh.size,) + shape).movedim(0, -2).reshape(
        shape[:-1] + (mesh.size * shape[-1],))
    return out.to(x.device)


def all_reduce(mesh: SpinMesh, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Elementwise sum (or max) of ``x`` over the ranks; a new tensor.  Integer
    sums are exact and order-free, so an int32 energy sum equals the
    unsharded one."""
    collective_counts["all_reduce"] += 1
    buf = _to_wire(mesh, x).clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return buf.to(x.device)


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
