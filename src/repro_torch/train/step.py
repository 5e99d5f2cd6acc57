"""Training step: chunked-vocab CE loss, microbatch accumulation, AdamW.

Port of ``repro.train.step``:

* the LM head never materialises (B, S, V) logits: the loss runs over
  sequence chunks, each under ``torch.utils.checkpoint``, so at most one
  (B, chunk, V) block of logits is live in the forward pass and the
  backward pass recomputes each chunk's;
* optional microbatch gradient accumulation in ``grad_accum_dtype``
  (bfloat16 halves a data-parallel all-reduce's payload);
* per-group remat is the model's (``ModelConfig.remat``, ``remat_block``).

The gradients are those of ``jax.grad``: taken with respect to the
parameters the forward pass sees — with ``param_compute_dtype`` set, the
cast copies, so they come out in that dtype (bfloat16) and the clip rounds
back to it, as the reference's do.  The loss's log-sum-exp is
``jax.nn.logsumexp``'s (the row maximum held constant), so the gradient
has the reference's form.  The bfloat16 roundings of the backward pass are
torch's and not XLA's transpose: the tests hold loss and gradients to the
JAX package within stated bfloat16 steps.

On a ``data`` × ``model`` (or ``pod`` × ``data`` × ``model``) mesh, for
the attention + MLP families under DEFAULT_RULES, every rank runs the same
step on its blocks (``convert.train_state_block``, ``lm_batch_block``;
its batch rows cut over the batch axes, ``sharding.batch_axes``):

* the loss is vocab-parallel where ``model`` cuts the vocabulary: each
  rank's (B, chunk, V/m) logits, the log-sum-exp's max and sum over
  ``model``, the label's logit from the rank that owns it; the full
  logits are never gathered and the backward pass stays local;
* ``tot`` and ``cnt`` are summed over the batch axes before ``tot /
  max(cnt, 1)``, so every rank's ``ce_loss`` and ``tokens`` are the whole
  batch's;
* each gradient leaf (after the microbatches) is summed over the batch
  axes, and over ``model`` too where a rank holds the leaf whole and its
  gradient is partial (``transformer.model_partial_grads``), in float32,
  rounded once to the gradient's dtype;
* AdamW keeps ZeRO-1 moments (``optim.adamw``).

A train step runs with ``torch.use_deterministic_algorithms`` on (and
``CUBLAS_WORKSPACE_CONFIG`` set if it was not): the embedding gather's
backward (an accumulating index put), the MoE gather path's scatter and
the CE gather's backward take their deterministic kernels on the card, so
two runs give the same bits and a resumed run replays an uninterrupted
one.  The MoE queue positions count in int32 (a floating cumsum has no
deterministic CUDA kernel).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from ..models import transformer as T
from ..models.layers import COMPUTE_DTYPE, F32, mm, split_axis
from ..models.params import init_params, param_pspecs, tree_map, tree_paths
from ..optim.adamw import AdamWConfig, OptState, adamw_init, adamw_update, zero1_spec
from ..sharding import (DEFAULT_RULES, NamedSharding, ShardingRules, all_reduce, batch_axes,
                        block, constrain, copy_to, reduce_from)

__all__ = ["TrainState", "TrainConfig", "chunked_ce_loss", "make_loss_fn", "grad_with_aux",
           "make_grad_fn", "make_train_step", "init_train_state", "train_state_shardings",
           "deterministic_algorithms"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    loss_chunk: int = 512          # sequence chunk for the vocab projection
    aux_coef: float = 0.01         # MoE load-balance loss coefficient
    grad_accum_dtype: Any = torch.float32  # bf16 → compressed DP all-reduce
    # the reference's scan-or-unroll choices; one loop here, the same values
    scan_microbatches: bool = True
    scan_loss_chunks: bool = True
    # bf16 → mixed precision with a float32 master: the forward and backward
    # passes see half-width params; AdamW updates the float32 ones.
    param_compute_dtype: Any = None


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside, the previous
    setting restored after; uninitialised memory is not filled (nothing
    here reads it), and cuBLAS gets the workspace setting the mode asks
    for when none was given."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[2]


def _logsumexp(x: torch.Tensor, mesh=None, axis=None) -> torch.Tensor:
    """``jax.nn.logsumexp`` over the last axis: the finite row maximum held
    constant (``stop_gradient``), log Σ exp(x − max) + max.  With a mesh
    ``axis`` the last axis is cut over it: the maximum and the sum are
    taken over the axis's ranks too."""
    amax = x.detach().amax(dim=-1, keepdim=True)
    if axis is not None:
        amax = all_reduce(mesh, amax, "max", axis)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    sumexp = torch.sum(torch.exp(x - amax), dim=-1)
    if axis is not None:
        sumexp = reduce_from(mesh, sumexp, axis)
    return torch.log(torch.abs(sumexp)) + amax[..., 0]


def _chunk_ce(h, head, lab, mesh, rules, va=None, v_lo=0):
    """(Σ CE over the chunk's unmasked positions, their count).  ``va``: the
    mesh axis that cuts the vocabulary (``head`` is this rank's columns
    from ``v_lo`` on), or None."""
    h = copy_to(mesh, h, va)
    logits = mm(h.to(COMPUTE_DTYPE), head.to(COMPUTE_DTYPE)).to(F32)
    logits = constrain(logits, mesh, ("batch", "seq", "vocab"), rules.replace(seq=None))
    lse = _logsumexp(logits, mesh, va)
    if va is None:
        ll = torch.gather(logits, -1, torch.clamp(lab, min=0).long()[..., None])[..., 0]
    else:
        # the label's logit, from the rank whose columns hold it
        n_v = logits.shape[-1]
        t = lab.long() - v_lo
        ll = torch.gather(logits, -1, t.clamp(0, n_v - 1)[..., None])[..., 0]
        ll = reduce_from(mesh, torch.where((t >= 0) & (t < n_v), ll, 0.0), va)
    mask = (lab >= 0).to(F32)
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def chunked_ce_loss(params, hidden, labels, cfg, *, mesh=None, rules=DEFAULT_RULES,
                    chunk=512, scan: bool = True):
    """Σ CE(logits, labels) over positions with labels >= 0, and their count.

    hidden (B,S,M); labels (B,S) int32 (-1 = masked).  Runs S in chunks;
    under autograd each chunk is checkpointed, so only one (B, chunk, V)
    block of logits is live at a time in either pass.  On a mesh the
    arguments are this rank's blocks (its batch rows; its vocabulary
    columns of the head where ``model`` cuts the vocabulary: vocab-parallel
    as :func:`_chunk_ce` says) and the sums this rank's rows'.
    """
    B, S, M = hidden.shape
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["embed"]["head"]
    va, v_ranks, v_idx = split_axis(mesh, cfg.vocab, "vocab", rules)
    v_lo = v_idx * (cfg.vocab // v_ranks)
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    cnt = torch.zeros((), dtype=F32, device=hidden.device)
    grad = torch.is_grad_enabled() and (hidden.requires_grad or head.requires_grad)
    for i in range(0, S, chunk):
        h, lab = hidden[:, i: i + chunk], labels[:, i: i + chunk]
        if grad:
            t, c = torch.utils.checkpoint.checkpoint(_chunk_ce, h, head, lab, mesh, rules, va,
                                                     v_lo, use_reentrant=False,
                                                     early_stop=mesh is None)
        else:
            t, c = _chunk_ce(h, head, lab, mesh, rules, va, v_lo)
        tot, cnt = tot + t, cnt + c
    return tot, cnt


def make_loss_fn(model_cfg, train_cfg: TrainConfig, mesh=None, rules=DEFAULT_RULES):
    def loss_fn(params, batch):
        hidden, aux = T.forward(params, batch, model_cfg, mesh=mesh, rules=rules)
        labels = batch["labels"]
        if model_cfg.frontend == "vision" and model_cfg.n_patches:
            # patch-prefix positions carry no next-token target
            prefix = torch.arange(labels.shape[1], device=labels.device) < model_cfg.n_patches
            labels = torch.where(prefix[None, :], torch.full_like(labels, -1), labels)
        tot, cnt = chunked_ce_loss(params, hidden, labels, model_cfg, mesh=mesh, rules=rules,
                                   chunk=train_cfg.loss_chunk, scan=train_cfg.scan_loss_chunks)
        if mesh is not None:  # the whole batch's sums on every rank
            tot = reduce_from(mesh, tot, batch_axes(mesh, rules))
            cnt = reduce_from(mesh, cnt, batch_axes(mesh, rules))
        loss = tot / torch.clamp(cnt, min=1.0)
        total = loss + train_cfg.aux_coef * aux
        return total, {"ce_loss": loss, "aux_loss": aux, "tokens": cnt}

    return loss_fn


def grad_with_aux(loss_fn, params, batch):
    """``jax.grad(loss_fn, has_aux=True)(params, batch)``: (gradients like
    ``params``, detached metrics); zeros for a parameter the loss does not
    reach."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
        total, metrics = loss_fn(leaves, batch)
        need = [t for _, t in tree_paths(leaves) if t.requires_grad]
        got = iter(torch.autograd.grad(total, need, allow_unused=True))

    def grad_of(t):
        g = next(got) if t.requires_grad else None
        return torch.zeros_like(t) if g is None else g

    return tree_map(grad_of, leaves), {k: v.detach() for k, v in metrics.items()}


def _microbatch_grads(loss_fn, params, batch, n_micro: int, accum_dtype,
                      scan: bool = True):
    """Gradients of ``n_micro`` microbatches (rows i·mb … (i+1)·mb),
    accumulated in ``accum_dtype`` in that order, then divided by n."""
    B = batch["tokens"].shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} is not a multiple of {n_micro} microbatches")
    mb = B // n_micro
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device), params)
    msum = None
    for i in range(n_micro):
        mbatch = {k: v[i * mb: (i + 1) * mb] for k, v in batch.items()}
        g, metrics = grad_with_aux(loss_fn, params, mbatch)
        acc = tree_map(lambda a, b: a + b.to(accum_dtype), acc, g)
        msum = metrics if msum is None else {k: msum[k] + metrics[k] for k in msum}
    # divide by tensors: CUDA takes ``tensor / scalar`` as a product with
    # the reciprocal, which is not the quotient for n = 3, 5, …
    grads = tree_map(lambda g: g / torch.tensor(n_micro, dtype=g.dtype, device=g.device), acc)
    out = {k: v / torch.tensor(n_micro, dtype=v.dtype, device=v.device) for k, v in msum.items()}
    out["tokens"] = msum["tokens"]
    return grads, out


def make_grad_fn(model_cfg, train_cfg: TrainConfig, mesh=None,
                 rules: ShardingRules = DEFAULT_RULES):
    """Returns ``grad_fn(params, batch) -> (grads, metrics)``: the gradients
    a train step hands to AdamW — taken at the ``param_compute_dtype``
    copies, over ``microbatches``, and on a mesh summed over the batch
    axes (and over ``model`` for :func:`~repro_torch.models.transformer.
    model_partial_grads`' leaves), in float32 and rounded once."""
    loss_fn = make_loss_fn(model_cfg, train_cfg, mesh, rules)
    if mesh is not None:
        T.check_mesh(model_cfg, mesh, rules, "make_train_step")
        partial = T.model_partial_grads(model_cfg, mesh, rules)
        axes = batch_axes(mesh, rules)

        def summed(g, part):
            return reduce_from(mesh, g.to(F32), axes + (("model",) if part else ())).to(g.dtype)

    def grad_fn(params, batch):
        cdt = train_cfg.param_compute_dtype
        params_c = (tree_map(lambda p: p.to(cdt) if p.is_floating_point() else p, params)
                    if cdt is not None else params)
        with deterministic_algorithms():
            if train_cfg.microbatches > 1:
                grads, metrics = _microbatch_grads(
                    loss_fn, params_c, batch, train_cfg.microbatches,
                    train_cfg.grad_accum_dtype, scan=train_cfg.scan_microbatches)
            else:
                grads, metrics = grad_with_aux(loss_fn, params_c, batch)
            del params_c
            if mesh is not None:
                grads = tree_map(summed, grads, partial)
        return grads, metrics

    return grad_fn


def make_train_step(
    model_cfg,
    train_cfg: TrainConfig,
    mesh=None,
    rules: ShardingRules = DEFAULT_RULES,
    param_specs=None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``: a pure
    function (new tensors out, none written in place).

    On a mesh ``state`` and ``batch`` are this rank's blocks
    (:func:`init_train_state`, ``convert.train_state_block``,
    ``lm_batch_block``) and ``param_specs`` the parameters' placements
    (``models.params.param_pspecs`` of the mesh when None); the metrics
    are the whole batch's on every rank."""
    grad_fn = make_grad_fn(model_cfg, train_cfg, mesh, rules)
    if mesh is not None and param_specs is None:
        param_specs = param_pspecs(T.model_defs(model_cfg), mesh, rules)

    def train_step(state: TrainState, batch):
        with deterministic_algorithms():
            grads, metrics = grad_fn(state.params, batch)
            new_params, new_opt, opt_metrics = adamw_update(
                state.params, grads, state.opt, train_cfg.opt, mesh=mesh,
                param_specs=param_specs)
        metrics = {**metrics, **opt_metrics, "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


def init_train_state(model_cfg, train_cfg: TrainConfig, seed: int = 0, *, device=None,
                     mesh=None, param_specs=None) -> TrainState:
    """Parameters from :func:`~repro_torch.models.params.init_params`
    (``seed``) and zero AdamW moments, on ``device`` (``cuda`` unless the
    caller passes another; on a mesh, the mesh's device).  On a mesh this
    rank's blocks (placed by ``param_specs``, ``param_pspecs`` of the mesh
    when None): each leaf drawn whole, as ``mesh=None`` draws it, and cut
    before the next is drawn, and the moments ZeRO-1's."""
    defs = T.model_defs(model_cfg)
    if mesh is None:
        params = init_params(defs, seed, device)
    else:
        if param_specs is None:
            param_specs = param_pspecs(defs, mesh)
        specs = dict(tree_paths(param_specs))
        params = init_params(defs, seed, mesh.device if device is None else device,
                             place=lambda path, d, leaf: block(mesh, leaf, specs[path]))
    opt = adamw_init(params, train_cfg.opt, mesh=mesh, param_specs=param_specs)
    return TrainState(params=params, opt=opt)


def train_state_shardings(model_cfg, train_cfg: TrainConfig, mesh,
                          rules: ShardingRules = DEFAULT_RULES) -> TrainState:
    """A TrainState of :class:`~repro_torch.sharding.NamedSharding`: each
    parameter's placement on ``mesh``, ``step`` replicated and the moments'
    ZeRO-1 placements (``optim.adamw.zero1_spec``) — the JAX package's
    ``train_lowering`` ``in_shardings``."""
    defs = T.model_defs(model_cfg)
    pspecs = param_pspecs(defs, mesh, rules)

    zero1 = train_cfg.opt.zero1
    mom = tree_map(lambda d, sp: NamedSharding(mesh, zero1_spec(sp, d.shape, mesh) if zero1
                                               else sp), defs, pspecs)
    return TrainState(params=tree_map(lambda sp: NamedSharding(mesh, sp), pspecs),
                      opt=OptState(step=NamedSharding(mesh, ()), mu=mom, nu=mom))
