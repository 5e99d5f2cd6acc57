"""AdamW with a warmup-cosine schedule and global-norm clipping.

Port of ``repro.optim.adamw``, as XLA compiles it on the CPU, in float32:

* the per-element update is the reference's fused loop after XLA's
  rewrites: ``m̂ / (√v̂ + ε)`` is ``m / (b1c · (√(v / b2c) + ε))``, and
  the compiled code fuses three adds into multiply-adds
  (``m·b1 + …``, ``v·b2 + …``, ``p·wd + …``) and the last step into
  ``p − lr·(…)``.  Each such fused step is ``a·b + c`` in float64 rounded
  once to float32 (as ``core/xla_math.py`` does), ``sqrt`` is rounded once
  through float64, every other step is a float32 operation.  float64
  arithmetic is IEEE on the CPU and the card, so both give the same bits;
* the schedule's scalars (the learning rate, ``1 − b1^t``, ``1 − b2^t``)
  are computed on the host from the step number: float32 steps, with
  ``cos`` and ``pow`` in float64 rounded to float32.  XLA's own ``cos`` and
  ``pow`` differ from these by at most one float32 ulp on a few steps in a
  thousand (the tests state it);
* ``global_norm`` squares and sums each leaf in float32 and adds the
  leaves in the reference's ``tree_leaves`` order (sorted dict keys); a
  leaf's sum runs in torch's order, XLA's in its own, a few float32 ulps
  apart.

Everything is a pure function: ``adamw_update`` returns new tensors and
writes into none it was given.

On a mesh (``sharding.Mesh``, or an ``AbstractMesh`` being lowered) the
parameters and gradients are this rank's blocks, placed by
``param_specs`` (``models.params.param_pspecs``), the gradients already
summed over the batch axes (``train.step``), and the moments ZeRO-1's:
each rank holds the ``zero1_spec`` block of ``mu``/``nu`` — the
parameter's spec plus ``data`` on the first free dim that ``data``
divides.  A rank updates its ``data`` slice of each parameter block with
its moments and all-gathers the new slices over ``data``; a leaf with no
such dim is updated whole on every rank.  The update is elementwise, so
the parameters and moments are those of the ``mesh=None`` update of the
joined gradients bit for bit, while the clip does not act; the global
norm counts each element once (squares summed over ``model`` only for the
leaves it cuts), its sum in another order than ``mesh=None``'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.xla_math import xla_sqrt
from ..models.params import tree_map
from ..sharding import all_gather, axis_index, mesh_axis_size, reduce_from

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm",
           "zero1_spec", "moment_spec", "tree_leaves"]

F32, F64 = torch.float32, torch.float64
# Elements per slice of the update: bounds its float64 temporaries (on the
# CPU, small enough to stay in cache).
_CHUNK = 1 << 24
_CPU_CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    zero1: bool = True  # shard moments over the data axis (on a mesh)


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any             # tree like params, float32
    nu: Any             # tree like params, float32


def tree_leaves(tree):
    """The leaves of nested dicts in ``jax.tree_util.tree_leaves`` order:
    dict keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _f32(v) -> np.float32:
    return np.float32(v)


def _schedule_np(cfg: AdamWConfig, step) -> np.ndarray:
    """The reference's float32 schedule at integer ``step`` (numpy)."""
    s = np.asarray(step, dtype=np.int64)
    warm = np.minimum(s.astype(np.float32) / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    prog = ((s - cfg.warmup_steps).astype(np.float32)
            / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)))
    prog = np.clip(prog, _f32(0.0), _f32(1.0))
    cos = np.cos((_f32(np.pi) * prog).astype(np.float64)).astype(np.float32)
    return ((_f32(cfg.lr_peak) * warm) * _f32(0.5)) * (_f32(1.0) + cos)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr_peak`` over ``warmup_steps``, then a cosine to
    0 at ``total_steps``: float32, at an integer step (a Python int, or an
    integer tensor, whose device the result takes)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    s = step.cpu().numpy() if isinstance(step, torch.Tensor) else step
    return torch.from_numpy(np.asarray(_schedule_np(cfg, s), np.float32)).to(dev)


def _bias_correction(b: float, t: int) -> np.float32:
    """``1 − b^t`` in float32, ``pow`` in float64 rounded to float32."""
    return _f32(1.0) - _f32(math.pow(float(_f32(b)), float(_f32(t))))


def _axes_of(spec) -> tuple:
    """The mesh axes a spec places its dims on, in order."""
    return tuple(a for e in spec for a in (e if isinstance(e, tuple) else (e,)) if a)


def global_norm(tree, *, mesh=None, param_specs=None) -> torch.Tensor:
    """√(Σ leaves Σ x²) in float32, the leaves in sorted-key order.  On a
    mesh ``tree`` holds this rank's blocks, placed by ``param_specs``:
    each element counts once — a leaf's sum of squares is summed over the
    axes that cut it (one all-reduce of the per-leaf sums per set of
    axes), and the leaves are added in the same order."""
    leaves = tree_leaves(tree)
    sums = [torch.sum(torch.square(leaf.to(F32))) for leaf in leaves]
    if mesh is not None:
        by_axes: dict = {}
        for i, spec in enumerate(tree_leaves(param_specs)):
            axes = tuple(a for a in _axes_of(spec) if mesh_axis_size(mesh, a) > 1)
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in sorted(by_axes.items()):
            whole = reduce_from(mesh, torch.stack([sums[i] for i in idx]), axes)
            for j, i in enumerate(idx):
                sums[i] = whole[j]
    total = 0
    for s in sums:
        total = total + s
    return xla_sqrt(torch.as_tensor(total, dtype=F32))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor numerator: torch takes ``scalar / tensor`` as a reciprocal
    # times the scalar, two roundings
    num = torch.tensor(max_norm, dtype=F32, device=norm.device)
    return torch.clamp(num / torch.clamp(norm, min=float(_f32(1e-9))), max=1.0)


def clip_by_global_norm(tree, max_norm):
    """(tree scaled by min(1, max_norm / norm), norm): each leaf scaled in
    float32 and cast back to its dtype, as the reference."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), tree), norm


def zero1_spec(spec, shape, mesh):
    """A parameter's spec extended with ``data`` on the first free dim that
    ``data`` divides (the ZeRO-1 moments' placement); ``spec`` itself where
    the mesh has no ``data`` axis or the spec already uses it.  Specs are
    :func:`~repro_torch.sharding.logical_to_spec`'s tuples."""
    if "data" not in mesh.shape:
        return spec
    data = mesh.shape["data"]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                used.add(a)
    if "data" in used:
        return spec
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % data == 0 and dim >= data:
            entries[i] = "data"
            while entries and entries[-1] is None:
                entries.pop()
            return tuple(entries)
    return spec


def _whole_shape(block_shape, spec, mesh) -> tuple:
    entries = tuple(spec) + (None,) * (len(block_shape) - len(spec))
    return tuple(d * mesh_axis_size(mesh, e) for d, e in zip(block_shape, entries))


def moment_spec(spec, block_shape, mesh, cfg: AdamWConfig) -> tuple:
    """The placement of a parameter block's moments: ``zero1_spec`` of
    the parameter's (``block_shape`` placed by ``spec``), or the
    parameter's own where ``cfg.zero1`` is off."""
    return zero1_spec(spec, _whole_shape(block_shape, spec, mesh), mesh) if cfg.zero1 else spec


def _data_dim(spec, mspec):
    """The dim ZeRO-1 placed on ``data`` (None where it placed none)."""
    for i, e in enumerate(mspec):
        if e == "data" and (i >= len(spec) or spec[i] != "data"):
            return i
    return None


def _specs(param_specs, what: str):
    if param_specs is None:
        raise ValueError(f"{what} on a mesh needs param_specs, the parameters' placements "
                         "(repro_torch.models.params.param_pspecs)")
    return param_specs


def adamw_init(params, cfg: AdamWConfig, *, mesh=None, param_specs=None) -> OptState:
    """Zero float32 moments like ``params`` and step 0 (on their device).
    On a mesh ``params`` are this rank's blocks and the moments its
    :func:`moment_spec` blocks."""
    if mesh is None:
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
    else:
        specs = _specs(param_specs, "adamw_init")

        def zeros(p, spec):
            mspec = moment_spec(spec, p.shape, mesh, cfg)
            i = _data_dim(spec, mspec)
            shape = list(p.shape)
            if i is not None:
                shape[i] //= mesh_axis_size(mesh, "data")
            return torch.zeros(shape, dtype=F32, device=p.device)

        mu = tree_map(zeros, params, specs)
        nu = tree_map(zeros, params, specs)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=mu, nu=nu)


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once: through float64, where the product
    of two float32 values is exact (``b`` a float32 value)."""
    return torch.add(c.to(F64), a.to(F64), alpha=b).to(F32)


def _update_leaf(p, g, m, v, scale, lr, b1c, b2c, cfg: AdamWConfig):
    """New (p, m, v) of one leaf, slice by slice."""
    # the reference's Python constants as the float32 values XLA folds them to
    b1, b2, ob1, ob2, eps, wd = (float(_f32(c)) for c in (
        cfg.b1, cfg.b2, 1 - cfg.b1, 1 - cfg.b2, cfg.eps, cfg.weight_decay))
    # b2c divides as a tensor: CUDA takes ``tensor / scalar`` as a product
    # with the scalar's reciprocal, which is not the quotient
    b1c, lr = float(b1c), float(lr)
    b2c = torch.tensor(b2c, dtype=F32, device=p.device)
    p_out = torch.empty_like(p)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    pf, gf, mf, vf = (t.reshape(-1) for t in (p, g, m, v))
    po, mo, vo = (t.view(-1) for t in (p_out, m_out, v_out))
    chunk = _CPU_CHUNK if p.device.type == "cpu" else _CHUNK
    for a in range(0, pf.numel(), chunk):
        sl = slice(a, a + chunk)
        gs = (gf[sl].to(F32) * scale).to(g.dtype).to(F32)       # the clip
        m_new = _fma(mf[sl], b1, gs * ob1)
        v_new = _fma(vf[sl], b2, (gs * gs) * ob2)
        den = (xla_sqrt(v_new / b2c) + eps) * b1c
        q = m_new / den
        p32 = pf[sl].to(F32)
        inner = _fma(p32, wd, q)
        po[sl] = _fma(inner, -lr, p32).to(p.dtype)
        mo[sl] = m_new
        vo[sl] = v_new
    return p_out, m_out, v_out


def adamw_update(params, grads, opt: OptState, cfg: AdamWConfig, *, mesh=None,
                 param_specs=None):
    """One AdamW step.  Returns (new_params, new_opt, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``.  On a mesh the
    trees are this rank's blocks (the moments ZeRO-1's, as
    :func:`adamw_init` makes them) and ``param_specs`` their placements."""
    specs = None if mesh is None else _specs(param_specs, "adamw_update")
    norm = global_norm(grads, mesh=mesh, param_specs=specs)
    scale = _clip_scale(norm, cfg.clip_norm)
    t = int(opt.step) + 1
    lr = _schedule_np(cfg, t)
    b1c, b2c = _bias_correction(cfg.b1, t), _bias_correction(cfg.b2, t)

    def upd(p, g, m, v):
        return _update_leaf(p, g, m, v, scale, lr, b1c, b2c, cfg)

    if mesh is None:
        out = tree_map(upd, params, grads, opt.mu, opt.nu)
    else:
        def one(p, g, m, v, spec):
            i = _data_dim(spec, moment_spec(spec, p.shape, mesh, cfg))
            if i is None:
                return upd(p, g, m, v)
            n = m.shape[i]
            lo = axis_index(mesh, "data") * n
            p_s, m_new, v_new = upd(p.narrow(i, lo, n).contiguous(),
                                    g.narrow(i, lo, n).contiguous(), m, v)
            return all_gather(mesh, p_s, i, "data"), m_new, v_new

        out = tree_map(one, params, grads, opt.mu, opt.nu, specs)
    new_params, new_mu, new_nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    step = opt.step + 1
    metrics = {"grad_norm": norm,
               "lr": torch.tensor(lr, dtype=F32, device=norm.device)}
    return new_params, OptState(step=step, mu=new_mu, nu=new_nu), metrics

