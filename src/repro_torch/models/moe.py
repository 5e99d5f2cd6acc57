"""Mixture-of-Experts FFN: top-k router and GShard-style capacity dispatch.

Port of ``repro.models.moe``: the router in float32, the iterative top-k,
a capacity of ceil(tokens_per_group · top_k / E · capacity_factor) per
expert and group with overflow tokens dropped (combine weight 0), the
sequence split into groups of ``seq_chunk`` tokens, and decode (S = 1)
folding the batch into one token group.  Two implementations of the
dispatch, chosen by ``cfg.moe_impl``: 'einsum' (one-hot dispatch and
combine tensors) and 'gather' (scatter-add in, gather out); both route
identically.

Routing is exact: on the same float32 probabilities both packages pick the
same experts, positions and gates (every step is an argmax, a product by
0 or 1, a count, a sum with one nonzero term, or the sum of the k gates
taken left to right, as XLA's reduction of a short row takes them).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..sharding import DEFAULT_RULES, ShardingRules, constrain, unported_on_mesh
from .layers import COMPUTE_DTYPE, F32, gelu, mm, silu
from .params import ParamDef

__all__ = ["moe_defs", "moe_ffn"]


def moe_defs(cfg) -> Dict[str, ParamDef]:
    M, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {
        "router": ParamDef((M, E), ("d_model", "experts"), scale=0.02),
        "wo": ParamDef((E, F_, M), ("experts", "d_ff", "d_model")),
    }
    if cfg.act == "swiglu":
        defs["wi"] = ParamDef((E, M, 2, F_), ("experts", "d_model", None, "d_ff"))
    else:
        defs["wi"] = ParamDef((E, M, F_), ("experts", "d_model", "d_ff"))
    return defs


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (short) axis, left to right."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def _top_k_mask(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative top-k: returns (gates (..., k), onehot (..., k, E)); each
    argmax takes the first maximal index, as ``jnp.argmax`` does."""
    E = probs.shape[-1]
    p = probs
    gates, onehots = [], []
    for _ in range(k):
        idx = torch.argmax(p, dim=-1)
        oh = F.one_hot(idx, E).to(probs.dtype)
        gates.append(torch.sum(p * oh, dim=-1))  # one nonzero term: exact
        onehots.append(oh)
        p = p * (1.0 - oh)
    return torch.stack(gates, dim=-1), torch.stack(onehots, dim=-2)


def _positions(onehot: torch.Tensor) -> torch.Tensor:
    """Each (token, choice)'s place in its expert's queue, priority (token,
    then choice rank): (G, T, k) float, from onehot (G, T, k, E)."""
    G, T, k, E = onehot.shape
    flat = onehot.reshape(G, T * k, E)
    # the running count in int32: the same whole numbers as a float cumsum,
    # and deterministic on the card (a floating cumsum is not, there)
    pos = (torch.cumsum(flat.to(torch.int32), dim=1).to(flat.dtype)) - flat
    return torch.sum(pos * flat, dim=-1).reshape(G, T, k)  # one nonzero term: exact


def _kept_gates(gates, keep):
    gates = gates * keep
    denom = torch.clamp(_row_sum(gates)[..., None], min=1e-9)
    return gates / denom


def _aux(probs, onehot):
    """Switch aux loss: E · Σ_e mean_tokens(top-1 fraction to e) · mean(prob e)."""
    E = probs.shape[-1]
    frac = torch.mean(onehot[:, :, 0, :], dim=1)
    mprob = torch.mean(probs, dim=1)
    return E * torch.mean(torch.sum(frac * mprob, dim=-1))


def _dispatch_combine(probs, k: int, cap: int):
    """The (G, T, E, cap) combine tensor of one token-group axis.

    probs: (G, T, E) router probabilities (float32); G groups of T tokens.
    Returns (combine (G,T,E,cap) float32, aux_loss scalar).
    """
    gates, onehot = _top_k_mask(probs, k)   # (G,T,k), (G,T,k,E)
    pos = _positions(onehot)                # (G,T,k)
    keep = (pos < cap).to(probs.dtype)
    gates = _kept_gates(gates, keep)
    pos_oh = F.one_hot(pos.long().clamp(max=cap), cap + 1)[..., :cap].to(probs.dtype)
    pos_oh = pos_oh * keep[..., None]
    # combine[g,t,e,c] = Σ_k gate · onehot_e · onehot_c (at most one k is nonzero)
    combine = torch.einsum("gtk,gtke,gtkc->gtec", gates, onehot, pos_oh)
    return combine, _aux(probs, onehot)


def _dispatch_gather(probs, k: int, cap: int):
    """Scatter/gather routing metadata, no (G,T,E,cap) one-hot tensors.

    Returns (e_idx, pos, gates, keep, aux): the first four (G, T, k).  The
    same experts, positions and gates as :func:`_dispatch_combine`.
    """
    gates, onehot = _top_k_mask(probs, k)
    pos = _positions(onehot).to(torch.int32)
    e_idx = torch.argmax(onehot, dim=-1).to(torch.int32)
    keep = pos < cap
    gates = _kept_gates(gates, keep.to(gates.dtype))
    return e_idx, pos, gates, keep, _aux(probs, onehot)


def _expert_compute(p, xin, cfg):
    """xin: (E, G, cap, M) → (E, G, cap, M), one weight set per expert."""
    cd = COMPUTE_DTYPE
    E, G, C, M = xin.shape
    x = xin.to(cd).reshape(E, G * C, M)
    if cfg.act == "swiglu":
        gu = torch.bmm(x, p["wi"].to(cd).reshape(E, M, -1)).reshape(E, G * C, 2, -1)
        h = silu(gu[..., 0, :]) * gu[..., 1, :]
    else:
        h = gelu(torch.bmm(x, p["wi"].to(cd)))
    return torch.bmm(h, p["wo"].to(cd)).reshape(E, G, C, M)


def _router_probs(p, xg):
    logits = mm(xg.to(F32), p["router"].to(F32))
    return torch.softmax(logits, dim=-1)


def _capacity(T: int, K: int, cfg) -> int:
    return max(1, int(math.ceil(T * K / cfg.n_experts * cfg.capacity_factor)))


def _run_group_einsum(p, xg, cfg):
    """xg: (G, T, M) — G token groups of T tokens each."""
    G, T, M = xg.shape
    cd = COMPUTE_DTYPE
    cap = _capacity(T, cfg.top_k, cfg)
    combine, aux = _dispatch_combine(_router_probs(p, xg), cfg.top_k, cap)
    dispatch = (combine > 0).to(cd)
    xin = torch.einsum("gtec,gtm->egcm", dispatch, xg.to(cd))
    xout = _expert_compute(p, xin, cfg)
    y = torch.einsum("gtec,egcm->gtm", combine.to(cd), xout)
    return y, aux


def _run_group_gather(p, xg, cfg):
    """Scatter-add dispatch / gather combine (no one-hot einsums)."""
    G, T, M = xg.shape
    cd = COMPUTE_DTYPE
    E, K = cfg.n_experts, cfg.top_k
    cap = _capacity(T, K, cfg)
    e_idx, pos, gates, keep, aux = _dispatch_gather(_router_probs(p, xg), K, cap)
    e_idx, pos = e_idx.long(), pos.long()
    g_ar = torch.arange(G, device=xg.device)[:, None, None].expand(G, T, K)
    pos_c = torch.where(keep, pos, torch.full_like(pos, cap))  # dropped → pad slot
    xin = torch.zeros((E, G, cap + 1, M), dtype=cd, device=xg.device)
    xin.index_put_((e_idx, g_ar, pos_c), xg[:, :, None, :].expand(G, T, K, M).to(cd),
                   accumulate=True)
    xout = _expert_compute(p, xin[:, :, :cap], cfg)
    y_tok = xout[e_idx, g_ar, torch.clamp(pos, max=cap - 1)]   # (G,T,K,M)
    # jnp.sum of bfloat16 accumulates in float32 and rounds once
    y = _row_sum((y_tok * gates[..., None].to(cd)).to(F32).movedim(2, -1))
    return y.to(cd), aux


def moe_ffn(
    p,
    x,  # (B, S, M)
    cfg,
    *,
    mesh=None,
    rules: ShardingRules = DEFAULT_RULES,
    seq_chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,M), aux_loss scalar float32).  One device only."""
    unported_on_mesh(mesh, "moe_ffn (MoE expert parallelism)", ".2")
    B, S, M = x.shape
    impl = getattr(cfg, "moe_impl", "einsum")
    run = _run_group_gather if impl == "gather" else _run_group_einsum

    def out(y):
        return constrain(y, mesh, ("batch", "seq", "d_model"), rules)

    if S == 1:  # decode: fold the batch into the token group
        y, aux = run(p, x.reshape(1, B, M), cfg)
        return out(y.reshape(B, 1, M)), aux

    chunk = min(seq_chunk, S)
    if S % chunk:
        chunk = S  # odd lengths: a single group
    n_chunks = S // chunk
    if n_chunks == 1:
        y, aux = run(p, x, cfg)
        return out(y), aux
    xc = x.reshape(B, n_chunks, chunk, M).movedim(1, 0)
    outs = [run(p, xc[i], cfg) for i in range(n_chunks)]
    y = torch.stack([o[0] for o in outs]).movedim(0, 1).reshape(B, S, M)
    return out(y), torch.mean(torch.stack([o[1] for o in outs]))
