"""The LM's dry-run lowerings on a mesh (port of ``repro.launch.lowering``).

Torch has no SPMD compiler: a cell is lowered by tracing the program one
rank runs (:mod:`repro_torch.core.lowering`, rank 0 of an
:class:`~repro_torch.sharding.AbstractMesh`, on fake tensors): the serving
program of :mod:`repro_torch.models.transformer`, or the train step of
:mod:`repro_torch.train.step` — forward, backward (the collectives of
the backward pass recorded too), the gradient sums and the ZeRO-1 AdamW
update.  Each argument carries the JAX package's placement
(:func:`train_args`, :func:`prefill_args`, :func:`decode_args`: the
reference's ``in_shardings``).

A trace visits every op, so trace time grows with depth: prefill at 32,768
tokens in chunks of 1,024 runs 528 live chunk pairs a layer.  A lowering
therefore traces the program at two and at three layer groups and
extrapolates, ``total(G) = f2 + (G − 2)·(f3 − f2)`` (the reference's rule
for its analysis lowering, from depths 2 and 3: the first group differs in
its peak), and the peak phase by phase; this is exact where the groups are
alike, as in every attention + MLP family.  :func:`prefill_lowering` and
:func:`decode_lowering` trace the deployment program (the configs' chunks:
the peak estimate); :func:`analysis_costs` traces :func:`analysis_config`
(``q_chunk = kv_chunk = S``, the reference's analysis lowering: its FLOPs,
bytes and collectives are what the roofline terms read).

The train step's peak phase by phase: the forward pass marks its groups
(prologue, each group, epilogue), and the epilogue holds the loss, the
backward pass and the optimizer, whose peak the extrapolation takes as
linear in the depth (the tests hold it to a whole trace at 5 groups).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Dict, List, Tuple

import torch

from ..configs import shapes as shp
from ..core.lowering import ArgInfo, CollectiveRecord, Lowering, block_shape, lower
from ..models import cache_defs, model_defs
from ..models import transformer as T
from ..models.params import param_pspecs, tree_paths
from ..optim.adamw import OptState
from ..sharding import DEFAULT_RULES, NamedSharding, logical_to_spec

__all__ = [
    "count_params",
    "batch_shardings",
    "train_args",
    "prefill_args",
    "decode_args",
    "CellLowering",
    "train_lowering",
    "prefill_lowering",
    "decode_lowering",
    "cell_lowering",
    "analysis_config",
    "analysis_costs",
]


# ---------------------------------------------------------------------------
# Parameter counting (MODEL_FLOPS)
# ---------------------------------------------------------------------------
def count_params(cfg) -> Tuple[int, int]:
    """(total, active) parameter counts.  Active discounts expert weights by
    top_k / n_experts (MoE): MODEL_FLOPS = 6·N_active·D."""
    total = active = 0
    for path, d in tree_paths(model_defs(cfg)):
        n = math.prod(d.shape)
        total += n
        is_expert = (cfg.n_experts > 0 and "ffn" in path and cfg.n_experts in d.shape
                     and "router" not in path)
        active += int(n * cfg.top_k / cfg.n_experts) if is_expert else n
    return total, active


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------
def batch_shardings(mesh, specs: Dict[str, torch.Tensor]) -> Dict[str, NamedSharding]:
    """Each input placed by ("batch", None, …)."""
    return {k: NamedSharding(mesh, logical_to_spec(
        mesh, v.shape, ("batch",) + (None,) * (v.dim() - 1))) for k, v in specs.items()}


def _param_shardings(defs, mesh):
    return {"/".join(path): NamedSharding(mesh, logical_to_spec(mesh, d.shape, d.axes))
            for path, d in tree_paths(defs)}


def _arg(name, shape, dtype, sharding: NamedSharding, mesh) -> ArgInfo:
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    return ArgInfo(name, tuple(shape), dtype, spec, block_shape(shape, spec, mesh))


def _def_args(prefix: str, defs, mesh) -> List[ArgInfo]:
    """ArgInfos of a ParamDef tree."""
    shard = _param_shardings(defs, mesh)
    return [_arg(f"{prefix}/{'/'.join(path)}", d.shape, d.dtype, shard["/".join(path)], mesh)
            for path, d in tree_paths(defs)]


def train_args(cfg, shape: shp.ShapeCell, mesh) -> Tuple[ArgInfo, ...]:
    """The train step's arguments: ``params/…``, ``opt/step`` (replicated),
    ``opt/mu/…`` and ``opt/nu/…`` (ZeRO-1) and ``batch/…``, each with the
    reference's placement (its ``train_lowering``'s ``in_shardings``)."""
    from ..train.step import TrainConfig, train_state_shardings

    defs = model_defs(cfg)
    shapes = dict(tree_paths(defs))
    opt = train_state_shardings(cfg, TrainConfig(), mesh).opt
    moments = [_arg(f"opt/{field}/{'/'.join(path)}", shapes[path].shape, torch.float32, ns, mesh)
               for field in ("mu", "nu") for path, ns in tree_paths(getattr(opt, field))]
    specs = shp.train_input_specs(cfg, shape)
    bshard = batch_shardings(mesh, specs)
    return tuple(_def_args("params", defs, mesh)
                 + [_arg("opt/step", (), torch.int32, opt.step, mesh)] + moments
                 + [_arg(f"batch/{k}", v.shape, v.dtype, bshard[k], mesh)
                    for k, v in specs.items()])


def prefill_args(cfg, shape: shp.ShapeCell, mesh) -> Tuple[ArgInfo, ...]:
    """The prefill step's arguments: ``params/…`` (the parameter paths)
    and ``batch/…``, each with the reference's placement."""
    specs = shp.prefill_input_specs(cfg, shape)
    bshard = batch_shardings(mesh, specs)
    return tuple(_def_args("params", model_defs(cfg), mesh)
                 + [_arg(f"batch/{k}", v.shape, v.dtype, bshard[k], mesh)
                    for k, v in specs.items()])


def decode_args(cfg, shape: shp.ShapeCell, mesh) -> Tuple[ArgInfo, ...]:
    """The decode step's arguments: ``params/…``, ``caches/…`` (a cache of
    ``seq_len`` positions), ``token`` and ``pos`` (replicated)."""
    specs = shp.decode_input_specs(cfg, shape)
    tok = NamedSharding(mesh, logical_to_spec(mesh, specs["token"].shape, ("batch",)))
    return tuple(_def_args("params", model_defs(cfg), mesh)
                 + _def_args("caches", cache_defs(cfg, shape.global_batch, shape.seq_len), mesh)
                 + [_arg("token", specs["token"].shape, torch.int32, tok, mesh),
                    _arg("pos", (), torch.int32, NamedSharding(mesh, ()), mesh)])


def _trees(args, blocks) -> Dict[str, Any]:
    """``{"params": {...}, "batch": {...}, ...}`` from the flat blocks."""
    out: Dict[str, Any] = {}
    for a, b in zip(args, blocks):
        node, *path = a.name.split("/")
        if not path:
            out[node] = b
            continue
        d = out.setdefault(node, {})
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = b
    return out


# ---------------------------------------------------------------------------
# Lowerings
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CellLowering:
    """A cell's lowering on one rank (every number per device), in the
    shape :func:`repro_torch.launch.hlo_analysis.roofline` reads: the whole
    program's arguments and, for the whole depth of ``n_groups`` groups,
    the numbers extrapolated from the traces at two and three groups
    (``traces``): FLOPs (and by dtype), bytes touched, the ops' count and
    the collectives (one group's repeated), and the peak estimate phase by
    phase."""

    kind: str
    mesh_shape: Dict[str, int]
    args_info: Tuple[ArgInfo, ...]
    argument_bytes: int
    n_groups: int
    flops: int
    flops_by_dtype: Dict[torch.dtype, int]
    bytes_accessed: int
    peak_bytes: int
    n_ops: int
    collectives: List[CollectiveRecord]
    traces: Tuple[Lowering, Lowering]
    seconds: float


def _depth(cfg, groups: int):
    return dataclasses.replace(cfg, n_layers=len(cfg.block) * groups)


# The depths traced: from the second group on every group is alike (the
# first differs: the embedding's output is still held while it runs).
DEPTHS = (2, 3)


def _extrapolate(f2, f3, G: int):
    """f(G) of a quantity linear in the depth from its values at 2 and 3."""
    return f2 + (G - 2) * (f3 - f2)


def _peak(l2: Lowering, l3: Lowering, G: int, argument_bytes: int) -> int:
    """The peak at ``G`` groups, phase by phase (the program marks each
    group and its epilogue, ``sharding.mark_phase``): from the second group
    on, group k holds what the groups before it left, so its peak is linear
    in k; the epilogue's and the arguments' are linear in the depth; the
    prologue's and the first group's are fixed."""
    if [label for label, _ in l3.phases] != ["prologue"] + ["group"] * 3 + ["epilogue"] or [
            label for label, _ in l2.phases] != ["prologue"] + ["group"] * 2 + ["epilogue"]:
        raise RuntimeError(f"unexpected phases {l2.phases} / {l3.phases}")
    (_, pro), (_, g1), (_, g2), (_, g3), (_, e3) = l3.phases
    e2 = l2.phases[-1][1]
    return argument_bytes + max(pro, g1, g2, _extrapolate(g2, g3, G), _extrapolate(e2, e3, G))


def _depth_collectives(l2: Lowering, l3: Lowering, G: int) -> List[CollectiveRecord]:
    """The collectives at ``G`` groups from the traces at two and three.

    A collective of both traces (same kind, axis, shape and dtype) is
    issued once at any depth; one over a stacked leaf (a train step's
    gradient sums and ZeRO-1 gathers: its leading dim the group count, 2
    and then 3) once with that dim at ``G``; the rest of the third trace's
    (one group's own) ``G − 2`` times.  Exact where the ZeRO-1 ``data``
    axis divides neither 2 nor 3 (else it cuts the stacked dim at one of
    the depths and not at the other): 4, 8 and 16 do not."""
    def key(c):
        return c.kind, c.axis, c.ranks, c.shape, c.dtype

    c2 = collections.Counter(key(c) for c in l2.collectives)
    common = c2 & collections.Counter(key(c) for c in l3.collectives)
    only2 = c2 - common
    left = collections.Counter(common)
    out, per_group = [], []
    for c in l3.collectives:
        k = key(c)
        if left[k]:
            left[k] -= 1
            out.append(c)
            continue
        twin = k[:3] + ((2,) + c.shape[1:], k[4])
        if c.shape[:1] == (3,) and only2[twin]:
            only2[twin] -= 1
            out.append(dataclasses.replace(c, shape=(G,) + c.shape[1:], bytes=c.bytes // 3 * G))
        else:
            per_group.append(c)
    if sum(only2.values()):
        raise RuntimeError(f"collectives of the two-group trace with no counterpart: {only2}")
    return out + (G - 2) * per_group


def _lower_cell(kind, cfg, shape, mesh, args_fn, program) -> CellLowering:
    """Trace ``program`` at two and three groups of ``cfg`` and extrapolate
    to its ``n_groups`` (at most three: traced whole); the arguments are
    those of the whole depth."""
    t0 = time.perf_counter()
    G = cfg.n_groups

    def trace(groups):
        cfg_g = _depth(cfg, groups)
        args = args_fn(cfg_g, shape, mesh)
        return lower(lambda m: program(cfg_g, m, args), args, mesh), args

    if G <= DEPTHS[-1]:
        whole, args = trace(G)
        return CellLowering(
            kind=kind, mesh_shape=dict(mesh.shape), args_info=args,
            argument_bytes=whole.argument_bytes, n_groups=G, flops=whole.flops,
            flops_by_dtype=dict(whole.flops_by_dtype), bytes_accessed=whole.bytes_accessed,
            peak_bytes=whole.peak_bytes, n_ops=len(whole.ops),
            collectives=list(whole.collectives), traces=(whole, whole),
            seconds=time.perf_counter() - t0)
    (l2, _), (l3, _) = trace(DEPTHS[0]), trace(DEPTHS[1])
    args = args_fn(cfg, shape, mesh)
    arg_bytes = sum(a.local_bytes for a in args)
    by_dtype = {dt: _extrapolate(l2.flops_by_dtype.get(dt, 0), l3.flops_by_dtype.get(dt, 0), G)
                for dt in {*l2.flops_by_dtype, *l3.flops_by_dtype}}
    return CellLowering(
        kind=kind, mesh_shape=dict(mesh.shape), args_info=args, argument_bytes=arg_bytes,
        n_groups=G, flops=_extrapolate(l2.flops, l3.flops, G), flops_by_dtype=by_dtype,
        bytes_accessed=_extrapolate(l2.bytes_accessed, l3.bytes_accessed, G),
        peak_bytes=_peak(l2, l3, G, arg_bytes),
        n_ops=_extrapolate(len(l2.ops), len(l3.ops), G),
        collectives=_depth_collectives(l2, l3, G),
        traces=(l2, l3), seconds=time.perf_counter() - t0)


def train_lowering(cfg, shape: shp.ShapeCell, mesh) -> CellLowering:
    """One train step of (arch × train cell × mesh) with the reference's
    ``TrainConfig()``, rank 0 traced on fakes.  ``opt/step`` is an argument of the reference's program; here
    the schedule's step is a Python int (the host computes the learning
    rate from it), and the trace takes step 0."""
    from ..train.step import TrainConfig, TrainState, make_train_step

    T.check_mesh(cfg, mesh, DEFAULT_RULES, "train_lowering")

    def program(cfg_g, m, args):
        step = make_train_step(cfg_g, TrainConfig(), mesh=m,
                               param_specs=param_pspecs(model_defs(cfg_g), m))

        def fn(*blocks):
            tree = _trees(args, blocks)
            opt = OptState(step=0, mu=tree["opt"]["mu"], nu=tree["opt"]["nu"])
            return step(TrainState(tree["params"], opt), tree["batch"])
        return fn

    return _lower_cell("train", cfg, shape, mesh, train_args, program)


def prefill_lowering(cfg, shape: shp.ShapeCell, mesh) -> CellLowering:
    """The prefill step of (arch × prefill cell × mesh), its caches padded
    to ``seq_len``: rank 0 traced on fakes.  No allocation."""
    T.check_mesh(cfg, mesh, DEFAULT_RULES, "prefill_lowering")

    def program(cfg_g, m, args):
        def fn(*blocks):
            tree = _trees(args, blocks)
            return T.prefill(tree["params"], tree["batch"], cfg_g, mesh=m, max_seq=shape.seq_len)
        return fn

    return _lower_cell("prefill", cfg, shape, mesh, prefill_args, program)


def decode_lowering(cfg, shape: shp.ShapeCell, mesh) -> CellLowering:
    """serve_step: one new token against a KV cache of ``seq_len``, rank 0
    traced on fakes.  ``pos`` is an argument of the reference's program;
    here the position is a Python int, and the trace takes position 0,
    which rank 0 holds, so that the traced rank is the one that writes the
    new K/V (the costlier case)."""
    T.check_mesh(cfg, mesh, DEFAULT_RULES, "decode_lowering")

    def program(cfg_g, m, args):
        def fn(*blocks):
            tree = _trees(args, blocks)
            return T.decode_step(tree["params"], tree["caches"], tree["token"], 0, cfg_g,
                                 mesh=m, max_seq=shape.seq_len)
        return fn

    return _lower_cell("decode", cfg, shape, mesh, decode_args, program)


def cell_lowering(cfg, shape: shp.ShapeCell, mesh) -> CellLowering:
    if shape.kind == "train":
        return train_lowering(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_lowering(cfg, shape, mesh)
    if shape.kind == "decode":
        return decode_lowering(cfg, shape, mesh)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# The analysis lowering: the reference's chunks widened to the whole
# sequence, traced at depths 2 and 3 and extrapolated.
# ---------------------------------------------------------------------------
def analysis_config(cfg, shape: shp.ShapeCell, depth_groups: int):
    """The reference's analysis config: ``depth_groups`` groups, unrolled,
    no remat, attention in one chunk of the whole sequence."""
    S = shape.seq_len
    return dataclasses.replace(cfg, n_layers=len(cfg.block) * depth_groups, scan_layers=False,
                               remat="none", q_chunk=S, kv_chunk=S)


def analysis_costs(cfg, shape: shp.ShapeCell, mesh) -> Dict[str, Any]:
    """Extrapolated whole-model FLOPs, bytes touched and collective bytes
    per device (the reference's keys: ``flops``, ``hbm_bytes``,
    ``coll_bytes``, each with ``_g1`` and ``_per_group``, and
    ``coll_breakdown``), and ``flops_f32`` and ``coll_ranks`` for the
    H100's terms."""
    from .hlo_analysis import collective_bytes

    wide = dataclasses.replace(analysis_config(cfg, shape, 1), n_layers=cfg.n_layers)
    low = cell_lowering(wide, shape, mesh)
    l2, l3 = low.traces
    whole = l2 is l3  # three groups or fewer: traced whole, no per-group figure
    c2, c3 = collective_bytes(l2), collective_bytes(l3)
    G = cfg.n_groups
    out: Dict[str, Any] = {}
    for k, (a, b) in {"flops": (l2.flops, l3.flops),
                      "hbm_bytes": (l2.bytes_accessed, l3.bytes_accessed),
                      "coll_bytes": (c2["total"], c3["total"])}.items():
        out[k] = a if whole else _extrapolate(a, b, G)
        out[f"{k}_g1"] = None if whole else _extrapolate(a, b, 1)
        out[f"{k}_per_group"] = None if whole else b - a
    out["coll_breakdown"] = c2 if whole else {k: _extrapolate(c2[k], c3[k], G) for k in c2}
    out["flops_f32"] = low.flops_by_dtype.get(torch.float32, 0)
    out["coll_ranks"] = max((c.ranks for c in low.collectives), default=1)
    out["seconds"] = low.seconds
    return out
