"""Roofline terms of a dry-run lowering on the H100 (port of
``repro.launch.hlo_analysis``).

The JAX package reads its terms from XLA's compiled artifact: FLOPs and
"bytes accessed" from ``cost_analysis()``, collective bytes parsed out of
the optimized HLO text.  The port produces no HLO, so its HLO-text parsers
have no counterpart here: :func:`roofline` reads the record of
:func:`repro_torch.core.lowering.lower` (one rank's step traced on fake
tensors) — FlopCounterMode's FLOPs, the aten ops' bytes touched, the
recorded collectives and the liveness peak — and :func:`collective_bytes`
and :func:`count_ops` read its op trace.

Hardware constants (:class:`HW`): one NVIDIA H100 80GB HBM3 (SXM) at its
700 W power limit, NVIDIA's data sheet, dense rates: 989.4 TFLOP/s in
bfloat16 on the tensor cores, 66.9 TFLOP/s in float32 on the CUDA cores
(the annealer's exact contractions; ``chip_smoke.py`` rounds it to 67),
3.35 TB/s of HBM3, 450 GB/s per direction of NVLink within a node of 8,
and 50 GB/s of NDR InfiniBand per GPU across nodes.  A collective over a
mesh axis of more than 8 ranks leaves the node, so it takes the
InfiniBand term; up to 8 (consecutive ranks: the last mesh axis is laid
out innermost) it takes NVLink's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

__all__ = [
    "HW",
    "collective_bytes",
    "count_ops",
    "model_flops",
    "roofline",
    "RooflineReport",
    "shape_bytes",
]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 80GB HBM3 (SXM) at 700 W."""

    peak_flops: float = 989.4e12      # bfloat16 dense FLOP/s (tensor cores)
    peak_flops_f32: float = 66.9e12   # float32 FLOP/s (CUDA cores)
    hbm_bw: float = 3.35e12           # HBM3 bytes/s
    link_bw: float = 450e9            # NVLink bytes/s per direction, within a node
    ib_bw: float = 50e9               # NDR InfiniBand bytes/s per GPU, across nodes
    node_gpus: int = 8                # GPUs an NVLink domain holds


_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
}

_COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def shape_bytes(dtype, dims_str: str) -> int:
    """Bytes of a ``dims_str`` ('128,256'; '' for a scalar) array of
    ``dtype``: an HLO dtype name ('f32', 'bf16', 's8', ...) or a torch
    dtype."""
    n = 1
    if dims_str:
        for d in dims_str.split(","):
            n *= int(d)
    width = dtype.itemsize if isinstance(dtype, torch.dtype) else _DTYPE_BYTES[dtype]
    return n * width


def collective_bytes(lowering) -> Dict[str, int]:
    """Result bytes of the lowering's collectives by kind (the JAX package's
    HLO names), and their ``'total'``: per device, per call."""
    out = {k: 0 for k in _COLLECTIVE_OPS}
    out["total"] = 0
    for c in lowering.collectives:
        out[c.kind] += c.bytes
        out["total"] += c.bytes
    return out


def count_ops(lowering, op: str) -> int:
    """Occurrences of the aten op ``op`` in the lowering's trace: ``'mm'``
    matches every overload of ``aten.mm``, ``'aten.mm.default'`` that one
    alone; a name never matches another op's prefix (``'mm'`` is not
    ``'bmm'``).  The contraction-count checks read it: a plateau's cycle
    loop holds one field contraction a cycle."""
    def name(full: str) -> str:
        return full.split(".")[1] if full.startswith("aten.") else full

    return sum(1 for o in lowering.ops if o.op == op or name(o.op) == op)


@dataclasses.dataclass
class RooflineReport:
    """Every byte and FLOP number is PER DEVICE (one rank's lowered call).
    ``flops_f32`` is the part of ``flops`` in float32, at the CUDA cores'
    rate; the rest runs at the bfloat16 tensor-core rate.  The collective
    term takes NVLink's rate when every collective's axis fits in a node
    (``coll_ranks`` ≤ ``hw.node_gpus``), InfiniBand's otherwise."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    n_chips: int
    peak_memory_per_device: Optional[float]
    hw: HW = dataclasses.field(default_factory=HW)
    flops_f32: float = 0.0
    coll_ranks: int = 1

    @property
    def t_compute(self) -> float:
        return ((self.flops - self.flops_f32) / self.hw.peak_flops
                + self.flops_f32 / self.hw.peak_flops_f32)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def link(self) -> str:
        return "nvlink" if self.coll_ranks <= self.hw.node_gpus else "infiniband"

    @property
    def t_collective(self) -> float:
        bw = self.hw.link_bw if self.link == "nvlink" else self.hw.ib_bw
        return self.coll_bytes / bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def asdict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "flops_f32_per_device": self.flops_f32,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "flops_global": self.flops * self.n_chips,
            "coll_breakdown": {k: int(v) for k, v in self.coll_breakdown.items()},
            "coll_link": self.link,
            "n_chips": self.n_chips,
            "peak_memory_per_device": self.peak_memory_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def roofline(lowering, n_chips: Optional[int] = None, hw: Optional[HW] = None) -> RooflineReport:
    """A RooflineReport from a :class:`~repro_torch.core.lowering.Lowering`
    (``n_chips``: the mesh's size unless given)."""
    coll = collective_bytes(lowering)
    return RooflineReport(
        flops=float(lowering.flops),
        hbm_bytes=float(lowering.bytes_accessed),
        coll_bytes=float(coll["total"]),
        coll_breakdown=coll,
        n_chips=math.prod(lowering.mesh_shape.values()) if n_chips is None else int(n_chips),
        peak_memory_per_device=float(lowering.peak_bytes),
        hw=hw or HW(),
        flops_f32=float(lowering.flops_by_dtype.get(torch.float32, 0)),
        coll_ranks=max((c.ranks for c in lowering.collectives), default=1),
    )


def model_flops(n_params_active: float, n_tokens: float, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (single forward / decode)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * n_tokens
