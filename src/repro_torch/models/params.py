"""Parameter definitions: one source of truth for shape, axes and init.

Port of ``repro.models.params``.  Each layer exposes ``*_defs(cfg) ->
nested dict of ParamDef``; from that tree come

* ``init_params``  — materialized tensors, each leaf drawn from its own
                     ``torch.Generator``,
* ``param_shapes``    — meta-device tensors (shapes and dtypes, no storage),
* ``param_pspecs``    — specs by the logical-axis rules
                        (:func:`repro_torch.sharding.logical_to_spec`),
* ``param_shardings`` — :class:`~repro_torch.sharding.NamedSharding` of a mesh.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Optional, Tuple

import torch

from ..sharding import DEFAULT_RULES, NamedSharding, ShardingRules, logical_to_spec

__all__ = ["ParamDef", "init_params", "param_shapes", "param_pspecs", "param_shardings",
           "stack_defs", "tree_defs_map", "tree_map", "tree_paths"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: Optional[float] = None  # stddev override for 'normal'
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank mismatch")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and over the matching leaves
    of ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_paths(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of every leaf of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def tree_defs_map(fn, defs):
    return tree_map(fn, defs)


def stack_defs(defs, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacking dim (the layer groups' stacked parameters)."""
    return tree_defs_map(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape, axes=(axis_name,) + d.axes),
        defs,
    )


def _leaf_seed(seed: int, path: Tuple[str, ...]) -> int:
    """A generator seed from the model seed and the leaf's path
    (``decoder/l0/mixer/wq``): the CRC-32 of both, equal in every
    interpreter run.  32 bits, because the CPU generator (mt19937) keeps
    only the low 32 bits of a seed."""
    return zlib.crc32(f"{int(seed)}:{'/'.join(path)}".encode())


def init_params(defs, seed: int = 0, device=None, *, place=None):
    """Materialize ``defs`` on ``device`` (``cuda`` unless the caller passes
    another).  Zeros and ones as named; 'normal' leaves are N(0, std²) with
    std = ``scale`` or 1/sqrt(fan-in) (the second-to-last dim), 'embed'
    leaves std = ``scale`` or 1, drawn in float32 and cast to the leaf's
    dtype — the JAX package's init.  Each leaf draws from a
    ``torch.Generator`` on ``device`` seeded by :func:`_leaf_seed`, so the
    values depend on the seed, the path and the device's generator: the
    CPU's and the card's differ, and a comparison across devices moves one
    set of parameters.  ``place(path, d, leaf)``, where given, maps each
    leaf as it is drawn (a mesh rank keeps its block), so the whole tree
    is never held at once."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: a CUDA device was requested but "
                           "torch.cuda.is_available() is False; pass device='cpu'")

    def init_one(path, d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        if d.init == "embed":
            std = d.scale if d.scale is not None else 1.0
        gen = torch.Generator(device=dev).manual_seed(_leaf_seed(seed, path))
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
        return (x * std).to(d.dtype)

    out: dict = {}
    for path, d in tree_paths(defs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        leaf = init_one(path, d)
        node[path[-1]] = leaf if place is None else place(path, d, leaf)
        del leaf
    return out


def param_shapes(defs):
    """Meta-device tensors of the defs' shapes and dtypes."""
    return tree_defs_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def param_pspecs(defs, mesh, rules: ShardingRules = DEFAULT_RULES):
    """Each leaf's spec on ``mesh`` by the logical-axis rules."""
    return tree_defs_map(lambda d: logical_to_spec(mesh, d.shape, d.axes, rules), defs)


def param_shardings(defs, mesh, rules: ShardingRules = DEFAULT_RULES):
    """Each leaf's :class:`~repro_torch.sharding.NamedSharding` on ``mesh``."""
    return tree_defs_map(
        lambda d: NamedSharding(mesh, logical_to_spec(mesh, d.shape, d.axes, rules)), defs)
