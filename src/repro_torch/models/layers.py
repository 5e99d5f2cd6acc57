"""Core transformer layers: norms, RoPE, GQA attention (qk-norm, the
chunked flash form, single-token decode), dense MLPs, embeddings.

Port of ``repro.models.layers``.  Conventions, as in the reference:

* parameters float32, compute bfloat16 (cast at use); softmax and norm
  statistics float32;
* activations (B, S, M); attention heads (B, S, H, D);
* each ``.astype`` of the reference is a rounding made here at the same
  place, and each ``preferred_element_type=float32`` product of bfloat16
  operands is a float32 product of the bfloat16 values (``_mm_f32``).

Every function takes ``mesh``/``rules`` like the reference's.  On a mesh
(``sharding.Mesh``, or an ``AbstractMesh`` being lowered) it is one rank's
program, run SPMD on that rank's blocks, placed by
:func:`~repro_torch.sharding.logical_to_spec` under DEFAULT_RULES:

* attention is head-parallel: a rank holds its q heads (and its KV heads
  where ``model`` divides them, all of them where it does not), reads the
  KV heads its q heads map to, and ``wo`` is row-parallel;
* the MLP is column-parallel into ``d_ff`` and row-parallel out of it;
* a row-parallel product is the float32 product of the bfloat16 operands
  on each rank, summed over ``model`` (all-reduce) and rounded to bfloat16
  once, as the whole product is;
* under autograd (training) the activation that enters a region cut over
  ``model`` passes :func:`~repro_torch.sharding.copy_to`, so its gradient,
  partial on each rank, is summed over ``model`` on the way back, and the
  row-parallel sum (:func:`~repro_torch.sharding.reduce_from`) passes the
  whole cotangent back unchanged.  Where ``model`` cuts the q heads but not
  the KV heads, ``wk``, ``wv``, ``q_norm`` and ``k_norm`` are whole on every
  rank and each rank's gradient of them is partial
  (:func:`attn_partial_grads`);
* decode against a cache cut by sequence (``kv_seq`` takes ``model``
  first, so its KV heads are whole) is flash-decode: every rank scores all
  q heads against its positions, and the softmax's max, sum and weighted
  values are all-reduced over ``model``; the rank holding ``pos`` writes
  the new K/V.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding import (DEFAULT_RULES, ShardingRules, all_gather, all_reduce, axis_index,
                        constrain, copy_to, logical_to_spec, mesh_axis_size, reduce_from,
                        require_default_rules, unported_on_mesh)
from .params import ParamDef

COMPUTE_DTYPE = torch.bfloat16
F32 = torch.float32

__all__ = [
    "COMPUTE_DTYPE",
    "rms_norm",
    "layer_norm",
    "norm_defs",
    "apply_norm",
    "rope",
    "attn_defs",
    "attention",
    "attention_decode",
    "mlp_defs",
    "mlp",
    "embed_defs",
    "gelu",
    "silu",
]


def mm(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Contract the last ``n_in`` dims of ``x`` with the first ``n_in`` of
    ``w`` (``einsum('...m,m...->...')``) in the operands' dtype."""
    k = math.prod(w.shape[:n_in])
    out = x.reshape(-1, k) @ w.reshape(k, -1)
    return out.reshape(x.shape[: x.dim() - n_in] + w.shape[n_in:])


def mm_cd(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """:func:`mm` of ``x`` and ``w`` cast to the compute dtype (bfloat16)."""
    return mm(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE), n_in)


class _Logistic(torch.autograd.Function):
    """``lax.logistic``: the value as XLA expands it, the gradient by the
    primitive's rule g · (σ · (1 − σ)), each op in the input's dtype.  The
    chain rule through the expansion would give inf · 0 = NaN wherever
    exp(−x) overflows (x below about −88), where the primitive's rule gives
    0."""

    @staticmethod
    def forward(ctx, x):
        ans = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return g * (ans * (1.0 - ans))


def logistic(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)) as XLA expands it, one op at a
    time in the input's dtype (in bfloat16 every step rounds; torch's fused
    ``sigmoid`` rounds once and differs); differentiable as ``lax.logistic``
    (:class:`_Logistic`)."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · logistic(x), each op in the input's dtype."""
    return x * logistic(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``, whose default is the tanh approximation (torch's
    default is the exact erf form), one op at a time in the input's dtype
    with its constants in that dtype, as jax traces it."""
    def c(v):  # the constant rounded to x's dtype, as a Python scalar
        return float(torch.tensor(v, dtype=x.dtype))

    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps=1e-6):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(F32)
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.to(F32) + bias.to(F32)
    return out.to(x.dtype)


def norm_defs(d_model: int, kind: str) -> Dict[str, ParamDef]:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d_model,), ("d_model",), init="ones")}
    if kind == "layernorm":
        return {
            "scale": ParamDef((d_model,), ("d_model",), init="ones"),
            "bias": ParamDef((d_model,), ("d_model",), init="zeros"),
        }
    raise ValueError(kind)


def apply_norm(p, x, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x, positions, theta: float = 1e4):
    """Rotary embedding; x (..., S, H, D) with integer positions
    broadcastable to x.shape[:-2]."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.pow(float(torch.tensor(theta, dtype=F32)),
                     -torch.arange(0, half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., None, None] * freq  # (..., 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def attn_defs(cfg) -> Dict[str, ParamDef]:
    M, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    defs = {
        "wq": ParamDef((M, H, D), ("d_model", "heads", "d_head")),
        "wk": ParamDef((M, K, D), ("d_model", "kv_heads", "d_head")),
        "wv": ParamDef((M, K, D), ("d_model", "kv_heads", "d_head")),
        "wo": ParamDef((H, D, M), ("heads", "d_head", "d_model")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((D,), ("d_head",), init="ones")
        defs["k_norm"] = ParamDef((D,), ("d_head",), init="ones")
    return defs


def _q(p, x, cfg, positions):
    q = mm_cd(x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
    return q


def _kv(p, x_kv, cfg, positions_kv):
    k = mm_cd(x_kv, p["wk"])
    v = mm_cd(x_kv, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    if cfg.rope_theta > 0:
        k = rope(k, positions_kv, cfg.rope_theta)
    return k, v


def _qkv(p, x, x_kv, cfg, positions, positions_kv):
    return (_q(p, x, cfg, positions),) + _kv(p, x_kv, cfg, positions_kv)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 batched product of bfloat16 operands: every product of two
    bfloat16 values is exact in float32, the sums are float32."""
    return torch.matmul(a.to(F32), b.to(F32))


def split_axis(mesh, n: int, logical: str, rules: ShardingRules = DEFAULT_RULES):
    """(mesh axis, ranks, this rank's index along it) of a dim of ``n``
    carrying ``logical``, as :func:`~repro_torch.sharding.logical_to_spec`
    places it; (None, 1, 0) where the dim stays whole (no mesh, or an axis
    that does not divide it).  A mesh runs DEFAULT_RULES only."""
    if mesh is None:
        return None, 1, 0
    require_default_rules(rules, f"the {logical!r} placement")
    spec = logical_to_spec(mesh, (n,), (logical,), rules)
    if not spec:
        return None, 1, 0
    return spec[0], mesh_axis_size(mesh, spec[0]), axis_index(mesh, spec[0])


def cache_seq_axis(cfg, mesh, max_seq: int, rules: ShardingRules = DEFAULT_RULES):
    """The mesh axis a cache of ``max_seq`` positions is cut over by
    sequence (("batch", "kv_seq", "kv_heads", "d_head")), or None."""
    if mesh is None:
        return None
    spec = logical_to_spec(mesh, (max_seq, cfg.n_kv_heads, cfg.d_head),
                           ("kv_seq", "kv_heads", "d_head"), rules)
    return spec[0] if spec else None


def check_block(t: torch.Tensor, dim: int, n: int, what: str) -> None:
    """ValueError unless ``t`` holds ``n`` along ``dim``: a rank passes its
    blocks (``convert.lm_params_block``), not the whole arrays."""
    if t.shape[dim] != n:
        raise ValueError(f"{what}: this rank's block has {t.shape[dim]} along dim {dim}, its "
                         f"placement gives {n}; pass the rank's blocks "
                         "(repro_torch.convert.lm_params_block / lm_caches_block)")


def row_parallel(x, w, n_in: int, mesh, axis):
    """``mm_cd(x, w, n_in)`` where the contracted dims are cut across the
    mesh ``axis``: each rank's float32 product of the bfloat16 operands,
    summed over the axis, then rounded to bfloat16 once."""
    if axis is None:
        return mm_cd(x, w, n_in)
    part = mm(x.to(COMPUTE_DTYPE).to(F32), w.to(COMPUTE_DTYPE).to(F32), n_in)
    return reduce_from(mesh, part, axis).to(COMPUTE_DTYPE)


def _kv_for_heads(k, v, q_lo: int, n_q: int, group: int, kv_lo: int):
    """The K/V heads (dim 2) read by q heads [q_lo, q_lo + n_q), q head h
    reading KV head h // ``group``; ``k`` and ``v`` hold KV heads from
    ``kv_lo`` on.  Contiguous runs of equal length stay a slice (GQA
    grouping); otherwise each q head's KV head is gathered (group 1)."""
    first, last = q_lo // group, (q_lo + n_q - 1) // group
    n_kv = last - first + 1
    if n_q % n_kv == 0 and all((q_lo + j) // group == first + j // (n_q // n_kv)
                               for j in range(n_q)):
        lo = first - kv_lo
        if lo == 0 and n_kv == k.shape[2]:
            return k, v
        return k[:, :, lo: lo + n_kv], v[:, :, lo: lo + n_kv]
    idx = torch.tensor([(q_lo + j) // group - kv_lo for j in range(n_q)], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _flash(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
           mesh=None, rules: ShardingRules = DEFAULT_RULES, kv_len=None):
    """Chunked online-softmax attention with GQA grouping.

    q (B,S,H,D), k/v (B,Skv,KVH,D).  Loops over q chunks (outer) and kv
    chunks (inner), holding at most (B,KVH,G,Cq,Ck) scores: the reference's
    two scans, with its padding, its -1e30 mask and its float32 softmax
    statistics.
    """
    B, S, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, Skv)
    S_orig, Skv_orig = S, Skv
    if S % q_chunk:
        q = F.pad(q, (0, 0, 0, 0, 0, -S % q_chunk))
        S = q.shape[1]
    if Skv % kv_chunk:
        pad = -Skv % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        Skv = k.shape[1]
        kv_len = Skv_orig if kv_len is None else min(kv_len, Skv_orig)
    nq, nk = S // q_chunk, Skv // kv_chunk
    scale = float(torch.tensor(1.0 / math.sqrt(D), dtype=F32))  # rounded to float32
    dev = q.device
    pos = torch.arange(max(S, Skv), device=dev)
    # Chunk pairs whose every key is masked for every query (causal, or past
    # kv_len) are skipped: each row has met a live key in kv chunk 0, so such
    # a pair would add p = exp(-1e30 - max) = 0 with corr = 1 and change no bit.
    skip = kv_len is None or kv_len >= 1

    # float32 operands cast once, laid out as each chunk's product reads them:
    # q (nq, B, KVH, G, Cq, D), kᵀ (nk, B, KVH, 1, D, Ck), v (nk, B, KVH, 1, Ck, D)
    f32 = dict(dtype=F32, memory_format=torch.contiguous_format)
    qb = q.reshape(B, nq, q_chunk, KVH, G, D).permute(1, 0, 3, 4, 2, 5).to(**f32)
    kb = k.reshape(B, nk, kv_chunk, KVH, D).permute(1, 0, 3, 4, 2).unsqueeze(3).to(**f32)
    vb = v.reshape(B, nk, kv_chunk, KVH, D).permute(1, 0, 3, 2, 4).unsqueeze(3).to(**f32)
    chunks = []
    for qi in range(nq):
        qc = qb[qi]
        q_pos = pos[qi * q_chunk: (qi + 1) * q_chunk]
        n_live = nk
        if skip and causal:
            n_live = min(n_live, ((qi + 1) * q_chunk - 1) // kv_chunk + 1)
        if skip and kv_len is not None:
            n_live = min(n_live, -(-kv_len // kv_chunk))
        acc = torch.zeros((B, KVH, G, q_chunk, D), dtype=F32, device=dev)
        mx = torch.full((B, KVH, G, q_chunk), -1e30, dtype=F32, device=dev)
        dn = torch.zeros((B, KVH, G, q_chunk), dtype=F32, device=dev)
        for ki in range(n_live):
            k_pos = pos[ki * kv_chunk: (ki + 1) * kv_chunk]
            s = torch.matmul(qc, kb[ki]) * scale  # (B,KVH,G,Cq,Ck)
            mask = q_pos[:, None] >= k_pos[None, :] if causal else None
            if kv_len is not None:
                live = k_pos[None, :] < kv_len
                mask = live if mask is None else mask & live
            if mask is not None:
                s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(mx, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(mx - m_new)
            dn = dn * corr + p.sum(dim=-1)
            pv = torch.matmul(p.to(v.dtype).to(F32), vb[ki])
            acc = acc * corr[..., None] + pv
            mx = m_new
        out = acc / torch.clamp(dn[..., None], min=1e-30)  # (B,KVH,G,Cq,D)
        chunks.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, D).to(q.dtype))
    out = torch.cat(chunks, dim=1)[:, :S_orig]
    return constrain(out, mesh, ("batch", "seq", "heads", "d_head"), rules)


def attention(
    p,
    x,
    cfg,
    *,
    mesh=None,
    rules: ShardingRules = DEFAULT_RULES,
    causal: bool = True,
    x_kv: Optional[torch.Tensor] = None,   # cross-attention source
    positions: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (train / prefill).  Returns (y, kv_cache).

    On a mesh: this rank's q heads and KV heads, the cache those KV heads
    over the whole sequence (``transformer.prefill`` re-cuts it by
    sequence for decode)."""
    if x_kv is not None:
        unported_on_mesh(mesh, "cross-attention (whisper's decoder)", ".4")
    B, S, _ = x.shape
    H, K = cfg.n_heads, cfg.n_kv_heads
    qa, q_ranks, q_idx = split_axis(mesh, H, "heads", rules)
    _, k_ranks, k_idx = split_axis(mesh, K, "kv_heads", rules)
    n_q, n_kv = H // q_ranks, K // k_ranks
    check_block(p["wq"], 1, n_q, "attention: wq")
    check_block(p["wk"], 1, n_kv, "attention: wk")
    x_kv = x if x_kv is None else x_kv
    Skv = x_kv.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    pos_kv = torch.arange(Skv, device=x.device).expand(B, Skv)
    if qa is not None:  # self-attention: a mesh runs no cross-attention
        x = x_kv = copy_to(mesh, x, qa)
    q, k, v = _qkv(p, x, x_kv, cfg, positions, pos_kv)
    ks, vs = _kv_for_heads(k, v, q_idx * n_q, n_q, H // K, k_idx * n_kv)
    out = _flash(q, ks, vs, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk, mesh=mesh,
                 rules=rules)
    y = row_parallel(out, p["wo"], 2, mesh, qa)
    return constrain(y, mesh, ("batch", "seq", "d_model"), rules), {"k": k, "v": v}


def attn_partial_grads(cfg, mesh, rules: ShardingRules = DEFAULT_RULES) -> Dict[str, bool]:
    """Which attention parameters a rank holds whole while its gradient of
    them is partial: where ``model`` cuts the q heads, ``q_norm`` and
    ``k_norm`` (each rank normalises its own heads), and ``wk``/``wv``
    where it leaves the KV heads whole (each rank reads only the KV heads
    of its q heads).  Their per-rank gradients sum over ``model``."""
    qa = split_axis(mesh, cfg.n_heads, "heads", rules)[0]
    ka = split_axis(mesh, cfg.n_kv_heads, "kv_heads", rules)[0]
    return {name: qa is not None and (name in ("q_norm", "k_norm") or ka is None)
            for name in attn_defs(cfg) if name not in ("wq", "wo")}


def _write(cache, pos: int, k_new, v_new):
    """A copy of the cache with position ``pos`` (a local index) set."""
    k, v = cache["k"].clone(), cache["v"].clone()
    k[:, pos] = k_new[:, 0].to(k.dtype)
    v[:, pos] = v_new[:, 0].to(v.dtype)
    return k, v


def attention_decode(
    p,
    x,          # (B, 1, M) current token activations
    cache,      # {"k": (B, Smax, KVH, D), "v": ...}
    pos,        # int — current position (same across the batch)
    cfg,
    *,
    mesh=None,
    rules: ShardingRules = DEFAULT_RULES,
    cross: bool = False,   # cross-attention: the cache is static, no update
    cross_len: Optional[int] = None,
    max_seq: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode against the cache (a new cache is returned; the
    one passed in is not written).  ``pos`` must lie inside the cache: the
    reference's ``dynamic_update_slice`` clamps a start past the end, which
    this raises on.

    On a mesh ``cache`` is this rank's block of a cache of ``max_seq``
    positions (required there), placed by ("batch", "kv_seq", "kv_heads",
    "d_head"): cut by sequence where ``model`` divides ``max_seq``
    (flash-decode), else by KV heads where it divides them."""
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if cross:
        unported_on_mesh(mesh, "cross-attention (whisper's decoder)", ".4")
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // K
    qa, q_ranks, q_idx = split_axis(mesh, H, "heads", rules)
    ka, k_ranks, k_idx = split_axis(mesh, K, "kv_heads", rules)
    n_q, n_kv = H // q_ranks, K // k_ranks
    check_block(p["wq"], 1, n_q, "attention_decode: wq")
    check_block(p["wk"], 1, n_kv, "attention_decode: wk")
    if mesh is None:
        max_seq = cache["k"].shape[1]
    elif max_seq is None:
        raise ValueError("attention_decode on a mesh needs max_seq, the cache's whole length")
    if not cross and not 0 <= pos < max_seq:
        raise IndexError(f"attention_decode: position {pos} outside a cache of {max_seq}")
    sa = cache_seq_axis(cfg, mesh, max_seq, rules)
    q = _q(p, x, cfg, positions)                                   # (B,1,n_q,D)
    scale = float(torch.tensor(math.sqrt(D), dtype=F32))
    if sa is None:
        # the whole sequence of this rank's KV heads (all K where model does not divide it)
        check_block(cache["k"], 2, n_kv, "attention_decode: the cache")
        check_block(cache["k"], 1, max_seq, "attention_decode: the cache")
        if cross:
            k, v = cache["k"], cache["v"]
            kv_len = cross_len if cross_len is not None else max_seq
        else:
            k, v = _write(cache, pos, *_kv(p, x, cfg, positions))
            kv_len = pos + 1
        ks, vs = _kv_for_heads(k, v, q_idx * n_q, n_q, G, k_idx * n_kv)
        n_sel = ks.shape[2]
        qg = q.reshape(B, n_sel, n_q // n_sel, D)                  # (B,KVH,G,D)
        s = _mm_f32(qg, ks.permute(0, 2, 3, 1)) / scale            # (B,KVH,G,Smax)
        live = torch.arange(max_seq, device=x.device) < kv_len
        s = torch.where(live, s, -1e30)
        w = torch.softmax(s, dim=-1)
        out = _mm_f32(w.to(vs.dtype), vs.permute(0, 2, 1, 3))      # (B,KVH,G,D)
        out = out.reshape(B, 1, n_q, D).to(COMPUTE_DTYPE)
    else:
        # flash-decode: this rank's positions [lo, lo + n_s) of every KV head
        n_s = max_seq // mesh_axis_size(mesh, sa)
        lo = axis_index(mesh, sa) * n_s
        check_block(cache["k"], 1, n_s, "attention_decode: the cache")
        check_block(cache["k"], 2, K, "attention_decode: the cache")
        k_new, v_new = _kv(p, x, cfg, positions)                   # (B,1,n_kv,D)
        if ka is not None:
            k_new, v_new = all_gather(mesh, k_new, 2, ka), all_gather(mesh, v_new, 2, ka)
        if lo <= pos < lo + n_s:
            k, v = _write(cache, pos - lo, k_new, v_new)
        else:
            k, v = cache["k"], cache["v"]
        qf = all_gather(mesh, q, 2, qa) if qa is not None else q    # every q head
        s = _mm_f32(qf.reshape(B, K, G, D), k.permute(0, 2, 3, 1)) / scale  # (B,K,G,n_s)
        live = torch.arange(lo, lo + n_s, device=x.device) < pos + 1
        s = torch.where(live, s, -1e30)
        mx = all_reduce(mesh, s.amax(dim=-1), "max", sa)
        e = torch.exp(s - mx[..., None])
        den = all_reduce(mesh, e.sum(dim=-1), "sum", sa)
        w = e / den[..., None]
        out = all_reduce(mesh, _mm_f32(w.to(v.dtype), v.permute(0, 2, 1, 3)), "sum", sa)
        out = out.reshape(B, 1, H, D).to(COMPUTE_DTYPE)[:, :, q_idx * n_q: (q_idx + 1) * n_q]
    y = row_parallel(out, p["wo"], 2, mesh, qa)
    new_cache = cache if cross else {"k": k, "v": v}
    return constrain(y, mesh, ("batch", "seq", "d_model"), rules), new_cache


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------
def mlp_defs(cfg, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    M = cfg.d_model
    F_ = d_ff or cfg.d_ff
    defs = {"wo": ParamDef((F_, M), ("d_ff", "d_model"))}
    if cfg.act == "swiglu":
        defs["wi"] = ParamDef((M, 2, F_), ("d_model", None, "d_ff"))
    else:
        defs["wi"] = ParamDef((M, F_), ("d_model", "d_ff"))
    return defs


def mlp(p, x, cfg, *, mesh=None, rules: ShardingRules = DEFAULT_RULES):
    """On a mesh ``wi`` and ``wo`` are this rank's blocks of ``d_ff``:
    column-parallel in, row-parallel out."""
    fa, f_ranks, _ = split_axis(mesh, cfg.d_ff, "d_ff", rules)
    check_block(p["wo"], 0, cfg.d_ff // f_ranks, "mlp: wo")
    x = copy_to(mesh, x, fa)
    if cfg.act == "swiglu":
        gu = mm_cd(x, p["wi"])
        h = silu(gu[..., 0, :]) * gu[..., 1, :]
    elif cfg.act == "gelu":
        h = gelu(mm_cd(x, p["wi"]))
    elif cfg.act == "relu_sq":
        h = torch.square(torch.relu(mm_cd(x, p["wi"])))
    else:
        raise ValueError(cfg.act)
    y = row_parallel(h, p["wo"], 1, mesh, fa)
    return constrain(y, mesh, ("batch", "seq", "d_model"), rules)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------
def embed_defs(cfg) -> Dict[str, ParamDef]:
    defs = {
        "tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "d_model"), init="embed", scale=0.02)
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab), ("d_model", "vocab"))
    return defs
