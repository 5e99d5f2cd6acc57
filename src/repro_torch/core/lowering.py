"""Dry-run lowering of a torch function on one rank of a mesh: the port's
counterpart of ``jax.jit(fn, in_shardings=...).lower(...)``.

Torch has no SPMD compiler to lower with.  :func:`lower` instead runs the
function that one rank runs, on that rank's blocks, under
``torch._subclasses.fake_tensor.FakeTensorMode``: every tensor is a fake
(shape, dtype and strides, no storage), so nothing is allocated and no card
is needed, and a mesh of any size — the production 16 × 16 or 2 × 16 × 16 —
is analysed from one process.  The mesh is an
:class:`~repro_torch.sharding.AbstractMesh` whose collectives are recorded
(kind, axis, bytes) and answered with a fake result, never issued.

The record, :class:`Lowering`, holds what XLA's compiled artifact gives the
JAX package's dry-run: each argument's global and per-device shape, dtype
and placement; the argument bytes per device; FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` (matrix products; elementwise
integer work counts none); the bytes touched — each aten op's input plus
output bytes, views excepted, the counterpart of "bytes accessed" before
any fusion; the collectives; a peak-bytes estimate from the fakes'
liveness (arguments, plus every op output from its creation until Python
drops it), also per phase of the program where it calls
:func:`~repro_torch.sharding.mark_phase` on its mesh (the LM marks each
layer group: the dry-run extrapolates each phase's peak over depth); and the op trace itself (aten op, output shapes and dtypes).

The fakes are CPU tensors: the steps traced here issue the same ops on
either device, and a fake CUDA tensor cannot be sliced in a CPU build of
torch.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from ..sharding import AbstractMesh, mesh_axis_size

__all__ = ["ArgInfo", "OpRecord", "CollectiveRecord", "Lowering", "lower", "block_shape",
           "dtype_name"]

# The JAX package's HLO dtype names, for the op trace's text.
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.uint16: "u16", torch.uint32: "u32",
    torch.uint64: "u64", torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


def dtype_name(dtype: torch.dtype) -> str:
    """The HLO name of a torch dtype (``torch.float32`` → ``'f32'``)."""
    return _DTYPE_NAMES[dtype]


def block_shape(shape: Sequence[int], spec: Sequence[Optional[str]], mesh) -> Tuple[int, ...]:
    """A rank's block of a ``shape`` placed by ``spec`` (a mesh axis or None
    per dim): ceil(dim / axis size) on each sharded dim, as a GSPMD shard
    pads a dim its axis does not divide."""
    return tuple(-(-int(d) // mesh_axis_size(mesh, a)) for d, a in zip(shape, spec))


@dataclasses.dataclass(frozen=True)
class ArgInfo:
    """One argument: its global shape, dtype and placement (``spec``: the
    mesh axis or None of each dim) and this rank's block shape."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Tuple[Optional[str], ...]
    local_shape: Tuple[int, ...]

    @property
    def local_bytes(self) -> int:
        return math.prod(self.local_shape) * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op of the trace: its outputs' shapes and dtypes, the bytes
    it touches (inputs read plus outputs written; 0 for a view) and its
    FLOPs (FlopCounterMode's count for the op; 0 for elementwise work)."""

    op: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    bytes: int
    flops: int


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective the rank would issue: its kind (the JAX package's
    HLO names: 'all-gather', 'all-reduce'), the mesh axis and its ranks,
    the result's shape and dtype, its bytes (the result's, as the JAX
    package's ``collective_bytes`` counts) and its place in the op trace
    (the number of ops before it)."""

    kind: str
    axis: str
    ranks: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    bytes: int
    index: int


@dataclasses.dataclass
class Lowering:
    """One rank's lowered call (every number per device)."""

    mesh_shape: Dict[str, int]
    args_info: Tuple[ArgInfo, ...]
    ops: List[OpRecord]
    collectives: List[CollectiveRecord]
    flops: int
    flops_by_dtype: Dict[torch.dtype, int]
    bytes_accessed: int
    argument_bytes: int
    peak_bytes: int
    phases: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    def as_text(self) -> str:
        """The trace, one line an op or collective, in order; shapes as the
        JAX package's lowered text writes them (``f32[8,64,64]`` and
        ``8x64x64xf32``)."""
        def shape_txt(shape, dtype):
            dims = ",".join(str(d) for d in shape)
            flat = "x".join(str(d) for d in (*shape, dtype_name(dtype)))
            return f"{dtype_name(dtype)}[{dims}] ({flat})"

        lines = [f"mesh {self.mesh_shape}"]
        lines += [f"arg {a.name}: {shape_txt(a.local_shape, a.dtype)} of "
                  f"{shape_txt(a.shape, a.dtype)} spec {a.spec}" for a in self.args_info]
        coll = {c.index: [] for c in self.collectives}
        for c in self.collectives:
            coll[c.index].append(c)
        for i, op in enumerate(self.ops + [None]):
            for c in coll.get(i, ()):
                lines.append(f"{c.kind} over {c.axis} ({c.ranks} ranks) -> "
                             f"{shape_txt(c.shape, c.dtype)}")
            if op is not None:
                outs = ", ".join(shape_txt(s, d) for s, d in zip(op.shapes, op.dtypes))
                lines.append(f"{op.op} -> {outs}")
        return "\n".join(lines)


def _storages(values) -> set:
    return {StorageWeakRef(v.untyped_storage()) for v in values if isinstance(v, torch.Tensor)}


class _Tracer(TorchDispatchMode):
    """Records every aten op dispatched under it, its bytes and FLOPs, and
    the live bytes of the tensors the ops create."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.ops: List[OpRecord] = []
        self.collectives: List[CollectiveRecord] = []
        self.live = self.peak = 0
        self._quiet = False
        self.phases: List[Tuple[str, int]] = [("prologue", 0)]

    def mark(self, label: str) -> None:
        """Start a phase: its peak begins at the bytes live now."""
        self.phases.append((label, self.live))

    def _track(self, t: torch.Tensor) -> None:
        nbytes = t.untyped_storage().nbytes()
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        label, top = self.phases[-1]
        if self.live > top:
            self.phases[-1] = (label, self.live)
        weakref.finalize(t, self._free, nbytes)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_in = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
        for a in (*args, *kwargs.values()):
            if isinstance(a, (list, tuple)):
                flat_in += [t for t in a if isinstance(t, torch.Tensor)]
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        inputs = _storages(flat_in)
        for o in outs:
            if StorageWeakRef(o.untyped_storage()) not in inputs:
                self._track(o)
        if self._quiet or not outs:
            return out
        nbytes = 0 if func.is_view else sum(t.nbytes for t in (*flat_in, *outs))
        flops = 0
        count = self._flop_registry.get(func.overloadpacket)
        if count is not None:
            flops = int(count(*args, **kwargs, out_val=out))
        self.ops.append(OpRecord(str(func), tuple(tuple(o.shape) for o in outs),
                                 tuple(o.dtype for o in outs), nbytes, flops))
        return out

    def collective(self, mesh, kind: str, axis: str, x: torch.Tensor, shape) -> torch.Tensor:
        """An abstract mesh's collective: recorded, answered with a fake of
        the result's shape (its buffer counts as live)."""
        self._quiet = True
        try:
            out = x.new_empty(shape)
        finally:
            self._quiet = False
        self.collectives.append(CollectiveRecord(kind, axis, mesh_axis_size(mesh, axis),
                                                 tuple(shape), x.dtype, out.nbytes,
                                                 len(self.ops)))
        return out


def lower(build: Callable, args: Sequence[ArgInfo], mesh) -> Lowering:
    """Run ``build(mesh')(*blocks)`` on rank 0's fake blocks of ``args``.

    ``mesh`` is a running :class:`~repro_torch.sharding.Mesh` or an
    :class:`~repro_torch.sharding.AbstractMesh`; only its shape is read.
    ``build`` takes the recording mesh ``mesh'`` (an abstract mesh of that
    shape) and returns the function one rank calls; real tensors it holds
    (a backend's J) enter the trace as fakes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    tracer = _Tracer()
    rec_mesh = AbstractMesh(tuple(mesh.shape), tuple(mesh.shape.values()))
    rec_mesh = dataclasses.replace(
        rec_mesh, phase=tracer.mark,
        record=lambda kind, axis, x, shape: tracer.collective(rec_mesh, kind, axis, x, shape))
    fn = build(rec_mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        blocks = [torch.empty(a.local_shape, dtype=a.dtype) for a in args]
        with FlopCounterMode(display=False) as counter, tracer:
            fn(*blocks)
    flops = int(counter.get_total_flops())
    by_dtype: Dict[torch.dtype, int] = {}
    for op in tracer.ops:
        if op.flops:
            by_dtype[op.dtypes[0]] = by_dtype.get(op.dtypes[0], 0) + op.flops
    if sum(by_dtype.values()) != flops:
        raise RuntimeError(f"FLOPs by op {sum(by_dtype.values())} != FlopCounterMode's {flops}")
    arg_bytes = sum(a.local_bytes for a in args)
    return Lowering(
        mesh_shape=dict(mesh.shape), args_info=tuple(args), ops=tracer.ops,
        collectives=tracer.collectives, flops=flops, flops_by_dtype=by_dtype,
        bytes_accessed=sum(op.bytes for op in tracer.ops), argument_bytes=arg_bytes,
        peak_bytes=arg_bytes + tracer.peak, phases=tracer.phases)
