"""Composable LM: dense / MoE / hybrid (Mamba) / RWKV / encoder–decoder.

Port of ``repro.models.transformer``.  A model is ``n_layers`` layers
arranged as repeats of a *block pattern*, a tuple of (mixer, ffn) pairs:

  granite/qwen/mistral/phi3v : (("attn",  "dense"),)
  olmoe/moonshot             : (("attn",  "moe"),)
  rwkv6                      : (("rwkv",  "rwkv"),)
  jamba (1 attn : 7 mamba,   : (("attn","moe"),("mamba","dense"),("mamba","moe"),
         MoE every 2nd layer)   ("mamba","dense"),("mamba","moe"),("mamba","dense"),
                                ("mamba","moe"),("mamba","dense"))

The parameters of one pattern repeat ("group") are stacked on a leading
axis (G, …), and a Python loop over the groups takes the place of the
reference's ``lax.scan``; the KV/SSM caches keep the same (G, …) stacking.

Training checkpoints the stack as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does: with ``remat="full"`` and autograd recording,
each group runs under ``torch.utils.checkpoint`` (non-reentrant), which
keeps only the group's inputs and recomputes the rest in the backward
pass; ``remat_block = k`` checkpoints k groups at a time (G/k residual
snapshots).  Neither changes a value.  ``scan_layers`` chooses between the
reference's scan and its unrolled loop, which are one loop here.

Entry points (pure functions of the parameters, a nested dict of tensors):

  forward(...)      -> (final hidden states, aux loss); differentiable
  prefill(...)      -> (last-position logits, caches); no autograd
  decode_step(...)  -> (logits, updated caches); no autograd

``forward``, ``prefill`` and ``decode_step`` take a ``data`` × ``model``
(or ``pod`` × ``data`` × ``model``) mesh for the families built of
``attn`` and ``dense`` blocks only, under DEFAULT_RULES: each rank passes
its blocks (``convert.lm_params_block``, ``lm_caches_block``,
``lm_batch_block``) and runs the same call.  The batch splits over
``("pod", "data")`` with no collective; the layers are tensor-parallel
over ``model`` (:mod:`.layers`); the embedding is vocab-parallel where
``model`` divides the vocabulary (one all-reduce), and the logits come
back gathered over the vocabulary.  prefill's caches come out in decode's placement: KV cut by
sequence where ``model`` divides ``max_seq`` (an all-to-all of each
group's head-cut K/V), by KV heads otherwise.  ``forward`` on a mesh is
differentiable: autograd passes back through the collectives
(``sharding.copy_to`` / ``reduce_from``), and under ``remat="full"`` each
checkpointed group is recomputed whole in the backward pass (early stop
off), so every rank issues the group's collectives again in the forward
pass's order (:func:`_scan_stack`).  MoE, Mamba, RWKV and the encoder on
a mesh raise NotImplementedError citing ROADMAP.md queue 1, steps
10.2–10.4.

:class:`LM` holds the parameters as an ``nn.Module`` (state-dict keys are
the reference's tree paths joined with '.') and calls these functions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..sharding import (DEFAULT_RULES, AbstractMesh, Mesh, all_to_all, axis_index, constrain,
                        gather_from, mark_phase, mesh_axis_size, reduce_from,
                        require_default_rules, unported_on_mesh)
from . import layers as L
from . import mamba as MB
from . import moe as MOE
from . import rwkv as RW
from .params import ParamDef, init_params, stack_defs, tree_map

__all__ = ["ModelConfig", "model_defs", "cache_defs", "forward", "prefill",
           "decode_step", "encode", "lm_head_logits", "LM"]

F32, BF16 = torch.float32, torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    block: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_seq_chunk: int = 512
    moe_impl: str = "einsum"  # 'einsum' (GShard dispatch) | 'gather'
    # attention
    qk_norm: bool = False
    rope_theta: float = 1e4  # 0 → no RoPE (whisper uses absolute positions)
    pos_embed: str = "rope"  # 'rope' | 'learned' | 'sincos'
    max_pos: int = 0         # size of the learned position table (0 = unused)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    # rwkv
    rwkv_head_dim: int = 64
    # enc-dec (whisper): encoder_layers > 0 adds an encoder + cross-attn
    encoder_layers: int = 0
    n_frames: int = 1500
    # frontends (stubs: precomputed embeddings)
    frontend: str = "none"  # 'none' | 'vision' | 'audio'
    n_patches: int = 0
    # numerics / structure
    norm: str = "rmsnorm"
    act: str = "swiglu"
    tie_embeddings: bool = False
    # training: 'full' checkpoints each group (or remat_block groups) in the
    # backward pass; scan_layers is the reference's scan-or-unroll choice
    remat: str = "full"  # 'full' | 'none'
    scan_layers: bool = True
    remat_block: int = 1

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.block) == 0, (self.n_layers, len(self.block))
        return self.n_layers // len(self.block)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1)-ish per token (SSM / hybrid)."""
        return any(mixer in ("mamba", "rwkv") for mixer, _ in self.block)

    @property
    def pure_attention(self) -> bool:
        return all(mixer == "attn" for mixer, _ in self.block)


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
def _mixer_defs(cfg, mixer: str):
    if mixer == "attn":
        return L.attn_defs(cfg)
    if mixer == "mamba":
        return MB.mamba_defs(cfg)
    if mixer == "rwkv":
        return RW.rwkv_defs(cfg)
    raise ValueError(mixer)


def _ffn_defs(cfg, ffn: str):
    if ffn == "dense":
        return L.mlp_defs(cfg)
    if ffn == "moe":
        return MOE.moe_defs(cfg)
    if ffn == "rwkv":
        return RW.rwkv_channel_defs(cfg)
    raise ValueError(ffn)


def _group_defs(cfg, cross_attn: bool = False):
    defs = {}
    for li, (mixer, ffn) in enumerate(cfg.block):
        d = {
            "norm1": L.norm_defs(cfg.d_model, cfg.norm),
            "mixer": _mixer_defs(cfg, mixer),
            "norm2": L.norm_defs(cfg.d_model, cfg.norm),
            "ffn": _ffn_defs(cfg, ffn),
        }
        if cross_attn:
            d["norm_x"] = L.norm_defs(cfg.d_model, cfg.norm)
            d["cross"] = L.attn_defs(cfg)
        defs[f"l{li}"] = d
    return defs


def _encoder_group_defs(cfg):
    return {
        "l0": {
            "norm1": L.norm_defs(cfg.d_model, cfg.norm),
            "mixer": L.attn_defs(cfg),
            "norm2": L.norm_defs(cfg.d_model, cfg.norm),
            "ffn": L.mlp_defs(cfg),
        }
    }


def model_defs(cfg: ModelConfig):
    enc_dec = cfg.encoder_layers > 0
    defs: Dict[str, Any] = {
        "embed": L.embed_defs(cfg),
        "final_norm": L.norm_defs(cfg.d_model, cfg.norm),
        "decoder": stack_defs(_group_defs(cfg, cross_attn=enc_dec), cfg.n_groups),
    }
    if cfg.pos_embed == "learned":
        assert cfg.max_pos > 0, "learned positions need max_pos"
        defs["pos"] = ParamDef((cfg.max_pos, cfg.d_model), (None, "d_model"), scale=0.02)
    if enc_dec:
        defs["encoder"] = stack_defs(_encoder_group_defs(cfg), cfg.encoder_layers)
        defs["enc_norm"] = L.norm_defs(cfg.d_model, cfg.norm)
    return defs


# ---------------------------------------------------------------------------
# Cache definitions
# ---------------------------------------------------------------------------
def _layer_cache_defs(cfg, mixer: str, ffn: str, batch: int, max_seq: int,
                      cross: bool = False):
    d: Dict[str, Any] = {}
    if mixer == "attn":
        kv = (batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        axes = ("batch", "kv_seq", "kv_heads", "d_head")
        d["mixer"] = {
            "k": ParamDef(kv, axes, init="zeros", dtype=BF16),
            "v": ParamDef(kv, axes, init="zeros", dtype=BF16),
        }
    elif mixer == "mamba":
        di = cfg.expand * cfg.d_model
        d["mixer"] = {
            "conv": ParamDef((batch, cfg.d_conv - 1, di), ("batch", None, "d_ff"),
                             init="zeros", dtype=BF16),
            "ssm": ParamDef((batch, di, cfg.d_state), ("batch", "d_ff", "ssm_state"),
                            init="zeros", dtype=F32),
        }
    elif mixer == "rwkv":
        h = cfg.d_model // cfg.rwkv_head_dim
        dd = cfg.rwkv_head_dim
        d["mixer"] = {
            "shift": ParamDef((batch, cfg.d_model), ("batch", "d_model"),
                              init="zeros", dtype=BF16),
            "wkv": ParamDef((batch, h, dd, dd), ("batch", "heads", None, None),
                            init="zeros", dtype=F32),
        }
    if ffn == "rwkv":
        d["ffn"] = {
            "shift": ParamDef((batch, cfg.d_model), ("batch", "d_model"),
                              init="zeros", dtype=BF16)
        }
    if cross:
        kv = (batch, cfg.n_frames, cfg.n_kv_heads, cfg.d_head)
        axes = ("batch", None, "kv_heads", "d_head")
        d["cross"] = {
            "k": ParamDef(kv, axes, init="zeros", dtype=BF16),
            "v": ParamDef(kv, axes, init="zeros", dtype=BF16),
        }
    return d


def cache_defs(cfg: ModelConfig, batch: int, max_seq: int):
    enc_dec = cfg.encoder_layers > 0
    group = {
        f"l{li}": _layer_cache_defs(cfg, mixer, ffn, batch, max_seq, cross=enc_dec)
        for li, (mixer, ffn) in enumerate(cfg.block)
    }
    return {"decoder": stack_defs(group, cfg.n_groups)}


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def _embed_tokens(params, tokens, cfg, mesh, rules):
    """The token rows, cast to bfloat16.  Vocab-parallel on a mesh where
    ``model`` divides the vocabulary: a rank looks up the tokens of its
    rows, zeros elsewhere, and one all-reduce sums them (one nonzero term:
    exact); under autograd the gradient reaches this rank's rows only."""
    tbl = params["embed"]["tok"]
    va, v_ranks, v_idx = L.split_axis(mesh, cfg.vocab, "vocab", rules)
    if va is None:
        x = tbl[tokens.long()].to(L.COMPUTE_DTYPE)
    else:
        n_v = cfg.vocab // v_ranks
        L.check_block(tbl, 0, n_v, "embed: tok")
        t = tokens.long() - v_idx * n_v
        rows = tbl[t.clamp(0, n_v - 1)].to(L.COMPUTE_DTYPE)
        x = reduce_from(mesh, torch.where(((t >= 0) & (t < n_v))[..., None], rows, 0), va)
    return constrain(x, mesh, ("batch", "seq", "d_model"), rules)


def lm_head_logits(params, x, cfg, mesh=None, rules=DEFAULT_RULES):
    """x (B, S, M) → logits (B, S, V) float32: a bfloat16 product (the
    logits are bfloat16 values) cast to float32, as the reference's.  On a
    mesh each rank computes its vocabulary block and the logits are
    gathered over it, so that every rank samples from all of them; under
    autograd each rank's slice of their gradient flows back to its
    block."""
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["embed"]["head"]
    va, v_ranks, _ = L.split_axis(mesh, cfg.vocab, "vocab", rules)
    L.check_block(head, 1, cfg.vocab // v_ranks, "lm head")
    logits = L.mm_cd(x, head).to(F32)
    if va is not None:
        logits = gather_from(mesh, logits, -1, va)
    return constrain(logits, mesh, ("batch", "seq", "vocab"), rules)


def _sincos_pos(S, M, offset=0, device=None):
    """The sinusoid table in float64 (numpy), then float32, as the reference."""
    pos = np.arange(S)[:, None] + offset
    dim = np.arange(M // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / M))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


def _add_positions(params, x, cfg, start):
    if cfg.pos_embed == "learned":
        S = x.shape[1]
        pos = params["pos"][start: start + S]
        return x + pos.to(x.dtype)
    if cfg.pos_embed == "sincos":
        return x + _sincos_pos(x.shape[1], cfg.d_model, start, x.device).to(x.dtype)
    return x  # rope is applied inside attention


# ---------------------------------------------------------------------------
# One group (pattern repeat), full-sequence form
# ---------------------------------------------------------------------------
def _apply_group(gp, x, cfg, mesh, rules, *, make_cache: bool, enc_out=None, causal=True):
    aux = torch.zeros((), dtype=F32, device=x.device)
    caches = {}
    for li, (mixer, ffn) in enumerate(cfg.block):
        lp = gp[f"l{li}"]
        lcache: Dict[str, Any] = {}
        h = L.apply_norm(lp["norm1"], x, cfg.norm)
        if mixer == "attn":
            y, c = L.attention(lp["mixer"], h, cfg, mesh=mesh, rules=rules, causal=causal,
                               q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
            if make_cache:
                lcache["mixer"] = {"k": c["k"].to(BF16), "v": c["v"].to(BF16)}
        elif mixer == "mamba":
            y, c = MB.mamba(lp["mixer"], h, cfg, mesh=mesh, rules=rules)
            if make_cache:
                lcache["mixer"] = {"conv": c["conv"].to(BF16), "ssm": c["ssm"]}
        elif mixer == "rwkv":
            y, c = RW.rwkv_time_mix(lp["mixer"], h, cfg, mesh=mesh, rules=rules)
            if make_cache:
                lcache["mixer"] = {"shift": c["shift"], "wkv": c["wkv"]}
        else:
            raise ValueError(mixer)
        x = x + y

        if enc_out is not None:
            h = L.apply_norm(lp["norm_x"], x, cfg.norm)
            y, cc = L.attention(lp["cross"], h, cfg, mesh=mesh, rules=rules, causal=False,
                                x_kv=enc_out, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
            if make_cache:
                lcache["cross"] = {"k": cc["k"].to(BF16), "v": cc["v"].to(BF16)}
            x = x + y

        h = L.apply_norm(lp["norm2"], x, cfg.norm)
        if ffn == "dense":
            y = L.mlp(lp["ffn"], h, cfg, mesh=mesh, rules=rules)
        elif ffn == "moe":
            y, a = MOE.moe_ffn(lp["ffn"], h, cfg, mesh=mesh, rules=rules,
                               seq_chunk=cfg.moe_seq_chunk)
            aux = aux + a
        elif ffn == "rwkv":
            y, c = RW.rwkv_channel_mix(lp["ffn"], h, cfg, mesh=mesh, rules=rules)
            if make_cache:
                lcache["ffn"] = {"shift": c["shift"]}
        else:
            raise ValueError(ffn)
        x = x + y
        caches[f"l{li}"] = lcache
    return x, caches, aux


def _group(stack, g: int):
    """Group ``g``'s slice of a (G, …)-stacked tree."""
    return tree_map(lambda t: t[g], stack)


def _groups(stack) -> list:
    """Every group's slice of a (G, …)-stacked tree, by one ``unbind`` per
    leaf: its backward stacks the G slices' gradients once, where G
    separate slices would each add a full-size (G, …) gradient."""
    unbound = tree_map(lambda t: t.unbind(0), stack)
    return [tree_map(lambda ts, g=g: ts[g], unbound) for g in range(_n_groups(stack))]


def _stack(trees):
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _n_groups(stack) -> int:
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


def _scan_stack(stack_params, x, cfg, mesh, rules, *, make_cache, enc_out=None,
                causal=True, place_cache=None):
    """The reference's scan over the stacked groups, as a loop.  Under
    autograd with ``remat="full"`` each block of ``remat_block`` groups
    (the reference's super-group; one group when it is 1) is
    checkpointed.  ``place_cache`` maps each group's caches as they are
    made (prefill on a mesh: to decode's placement)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    groups = _groups(stack_params)
    k = cfg.remat_block if cfg.scan_layers and not make_cache else 1
    if len(groups) % k:
        raise ValueError(f"remat_block {k} does not divide the {len(groups)} groups")
    if make_cache or cfg.remat != "full" or not torch.is_grad_enabled():
        all_caches = []
        for gp in groups:
            mark_phase(mesh, "group")
            x, caches, a = _apply_group(gp, x, cfg, mesh, rules, make_cache=make_cache,
                                        enc_out=enc_out, causal=causal)
            aux = aux + a
            all_caches.append(place_cache(caches) if place_cache else caches)
        mark_phase(mesh, "epilogue")
        return x, (_stack(all_caches) if make_cache else None), aux

    def block(xx, aux_sum, gps):
        for gp in gps:
            xx, _, a = _apply_group(gp, xx, cfg, mesh, rules, make_cache=False,
                                    enc_out=enc_out, causal=causal)
            aux_sum = aux_sum + a
        return xx, aux_sum

    # On a mesh every rank must issue the same collectives in the same
    # order.  The backward pass runs its nodes in the reverse of their
    # creation order, the same on every rank, and a checkpointed block's
    # recomputation starts at its first saved tensor; with early stop off
    # it runs the block whole, every collective of its forward pass
    # included, whatever tensors each rank's ops save.
    for i in range(0, len(groups), k):
        for _ in range(k):
            mark_phase(mesh, "group")
        # non-reentrant: the parameters reach the block by closure and still
        # get their gradients; only x and aux are kept for the backward pass
        x, aux = torch.utils.checkpoint.checkpoint(
            lambda xx, aa, gps=groups[i: i + k]: block(xx, aa, gps), x, aux,
            use_reentrant=False, early_stop=mesh is None)
    mark_phase(mesh, "epilogue")
    return x, None, aux


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------
def encode(params, frames, cfg, *, mesh=None, rules=DEFAULT_RULES):
    """frames (B, F, M): precomputed conv-frontend embeddings (a stub)."""
    unported_on_mesh(mesh, "the encoder (whisper)", ".4")
    x = frames.to(L.COMPUTE_DTYPE)
    x = x + _sincos_pos(x.shape[1], cfg.d_model, device=x.device).to(x.dtype)
    x, _, _ = _scan_stack(params["encoder"], x, cfg, mesh, rules, make_cache=False,
                          causal=False)
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def _embed_inputs(params, batch, cfg, mesh, rules, start=0):
    """tokens and the optional frontend embeddings → (B, S, M)."""
    x = _embed_tokens(params, batch["tokens"], cfg, mesh, rules)
    if cfg.frontend == "vision" and "patches" in batch:
        # the stubbed CLIP tower: precomputed patch embeddings replace the prefix
        p = batch["patches"].to(x.dtype)
        x = torch.cat([p, x[:, cfg.n_patches:]], dim=1)
    return _add_positions(params, x, cfg, start)


def _encoder_out(params, batch, cfg, mesh, rules):
    if cfg.encoder_layers > 0:
        return encode(params, batch["frames"], cfg, mesh=mesh, rules=rules)
    return None


def forward(params, batch, cfg, *, mesh=None, rules=DEFAULT_RULES):
    """Forward over the whole sequence → (hidden (B,S,M), aux_loss).
    Differentiable: autograd records it where the parameters (or inputs)
    require grad.  On a mesh the arguments are this rank's blocks and the
    hidden states its batch rows, whole over ``model``."""
    if mesh is not None:
        check_mesh(cfg, mesh, rules, "forward")
    enc_out = _encoder_out(params, batch, cfg, mesh, rules)
    x = _embed_inputs(params, batch, cfg, mesh, rules)
    x, _, aux = _scan_stack(params["decoder"], x, cfg, mesh, rules, make_cache=False,
                            enc_out=enc_out)
    return L.apply_norm(params["final_norm"], x, cfg.norm), aux


def check_mesh(cfg, mesh, rules, what: str) -> None:
    """The LM runs on a mesh for the families built of ``attn`` and
    ``dense`` blocks, under DEFAULT_RULES: anything else raises
    NotImplementedError citing ROADMAP.md queue 1, step 10 (10.2–10.5)."""
    if not isinstance(mesh, (Mesh, AbstractMesh)):
        raise TypeError(f"{what}: mesh must be a repro_torch.sharding Mesh or AbstractMesh "
                        f"(repro_torch.launch.mesh.make_mesh), got {type(mesh).__name__}")
    require_default_rules(rules, what)
    others = sorted({b for pair in cfg.block for b in pair} - {"attn", "dense"})
    if others:
        # MoE expert parallelism is step 10.2, Mamba and RWKV 10.3
        unported_on_mesh(mesh, f"{what}: {cfg.name}'s {', '.join(others)} blocks",
                         ".2" if others == ["moe"] else ".3")
    if cfg.encoder_layers > 0:
        unported_on_mesh(mesh, f"{what}: {cfg.name}'s encoder and cross-attention", ".4")


def model_partial_grads(cfg, mesh, rules=DEFAULT_RULES):
    """A tree like the parameters: True where a rank holds the leaf whole
    while its gradient of it is partial, so that the ranks' gradients sum
    over ``model`` (:func:`repro_torch.models.layers.attn_partial_grads`);
    every other leaf's gradient is whole on each rank of a ``model`` line
    (its own block, or a leaf used outside the regions cut over
    ``model``)."""
    from .params import tree_defs_map

    out = tree_defs_map(lambda d: False, model_defs(cfg))
    attn = L.attn_partial_grads(cfg, mesh, rules)
    for li, (mixer, _) in enumerate(cfg.block):
        if mixer == "attn":
            out["decoder"][f"l{li}"]["mixer"].update(attn)
    return out


def _decode_placement(caches, cfg, mesh, rules, max_seq):
    """One group's prefill K/V, (B, S, KVH', D), padded along the sequence
    to ``max_seq`` and, on a mesh, placed as decode reads them: cut by
    sequence where it takes ``model`` (an all-to-all from the head cut, or
    a slice where the heads are whole), else as they are.  Only the 'attn'
    mixers' K/V are padded: the reference pads every rank-5 leaf whose
    axis 2 equals the prompt length, which also catches an RWKV state when
    the prompt is as long as the head count and whisper's cross-attention
    K/V when it is ``n_frames`` long; those stay as they are here."""
    sa = L.cache_seq_axis(cfg, mesh, max_seq, rules)
    ka = L.split_axis(mesh, cfg.n_kv_heads, "kv_heads", rules)[0]
    out = dict(caches)
    for li, (mixer, _) in enumerate(cfg.block):
        if mixer != "attn":
            continue
        lc = dict(out[f"l{li}"])
        kv = {}
        for name, c in lc["mixer"].items():
            if max_seq != c.shape[1]:
                c = F.pad(c, (0, 0, 0, 0, 0, max_seq - c.shape[1]))
            if sa is not None and ka is not None:
                c = all_to_all(mesh, c, 1, 2, sa)
            elif sa is not None:
                n_s = max_seq // mesh_axis_size(mesh, sa)
                c = c.narrow(1, axis_index(mesh, sa) * n_s, n_s).clone()
            kv[name] = c
        lc["mixer"] = kv
        out[f"l{li}"] = lc
    return out


@torch.no_grad()
def prefill(params, batch, cfg, *, mesh=None, rules=DEFAULT_RULES, max_seq=None):
    """Prefill → (last-position logits (B,V), caches).

    The self-attention caches are padded to ``max_seq`` (default: the
    prompt length) so that decode can continue.  On a mesh the arguments
    and the caches are this rank's blocks and the logits this rank's
    batch rows over the whole vocabulary.
    """
    if mesh is not None:
        check_mesh(cfg, mesh, rules, "prefill")
    enc_out = _encoder_out(params, batch, cfg, mesh, rules)
    x = _embed_inputs(params, batch, cfg, mesh, rules)
    S = x.shape[1]
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"prefill: max_seq {max_seq} is shorter than the prompt ({S})")
    x, caches, _ = _scan_stack(
        params["decoder"], x, cfg, mesh, rules, make_cache=True, enc_out=enc_out,
        place_cache=lambda c: _decode_placement(c, cfg, mesh, rules, max_seq))
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_head_logits(params, x[:, -1:], cfg, mesh, rules)[:, 0]
    return logits, {"decoder": caches}


def _sincos_table_lookup(cfg, pos: int, device):
    """The closed-form sinusoid of one position, in float32."""
    M = cfg.d_model
    dim = torch.arange(M // 2, dtype=F32, device=device)
    ang = torch.tensor(float(pos), dtype=F32, device=device) / torch.pow(
        torch.tensor(10000.0, dtype=F32, device=device), 2 * dim / M)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


@torch.no_grad()
def decode_step(params, caches, token, pos, cfg, *, mesh=None, rules=DEFAULT_RULES,
                max_seq=None):
    """One decode step.  token (B,), pos int → (logits (B,V), new caches);
    the caches passed in are not written.  On a mesh the arguments are this
    rank's blocks and ``max_seq`` (required there) is the caches' whole
    sequence length, which their placement depends on."""
    pos = int(pos)
    if mesh is not None:
        check_mesh(cfg, mesh, rules, "decode_step")
        if max_seq is None:
            raise ValueError("decode_step on a mesh needs max_seq, the caches' whole length")
    x = _embed_tokens(params, token[:, None], cfg, mesh, rules)
    if cfg.pos_embed == "learned":
        x = x + params["pos"][pos: pos + 1].to(x.dtype)
    elif cfg.pos_embed == "sincos":
        x = x + _sincos_table_lookup(cfg, pos, x.device).to(x.dtype)
    outs = []
    for g in range(_n_groups(params["decoder"])):
        mark_phase(mesh, "group")
        x, new_gc = _decode_group(_group(params["decoder"], g), _group(caches["decoder"], g),
                                  x, pos, cfg, mesh, rules, max_seq)
        outs.append(new_gc)
    mark_phase(mesh, "epilogue")
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_head_logits(params, x, cfg, mesh, rules)[:, 0]
    return logits, {"decoder": _stack(outs)}


def _decode_group(gp, gc, x, pos, cfg, mesh, rules, max_seq=None):
    new_cache = {}
    for li, (mixer, ffn) in enumerate(cfg.block):
        lp = gp[f"l{li}"]
        lc = gc[f"l{li}"]
        nc: Dict[str, Any] = {}
        h = L.apply_norm(lp["norm1"], x, cfg.norm)
        if mixer == "attn":
            y, c = L.attention_decode(lp["mixer"], h, lc["mixer"], pos, cfg, mesh=mesh,
                                      rules=rules, max_seq=max_seq)
            nc["mixer"] = c
        elif mixer == "mamba":
            y, c = MB.mamba_decode(lp["mixer"], h, lc["mixer"], cfg, mesh=mesh, rules=rules)
            nc["mixer"] = {"conv": c["conv"].to(BF16), "ssm": c["ssm"]}
        elif mixer == "rwkv":
            y, c = RW.rwkv_time_mix_decode(lp["mixer"], h, lc["mixer"], cfg, mesh=mesh,
                                           rules=rules)
            nc["mixer"] = {"shift": c["shift"], "wkv": c["wkv"]}
        else:
            raise ValueError(mixer)
        x = x + y

        if "cross" in lc:
            h = L.apply_norm(lp["norm_x"], x, cfg.norm)
            y, _ = L.attention_decode(lp["cross"], h, lc["cross"], pos, cfg, mesh=mesh,
                                      rules=rules, cross=True)
            nc["cross"] = lc["cross"]
            x = x + y

        h = L.apply_norm(lp["norm2"], x, cfg.norm)
        if ffn == "dense":
            y = L.mlp(lp["ffn"], h, cfg, mesh=mesh, rules=rules)
        elif ffn == "moe":
            y, _ = MOE.moe_ffn(lp["ffn"], h, cfg, mesh=mesh, rules=rules)
        elif ffn == "rwkv":
            y, c = RW.rwkv_channel_mix_decode(lp["ffn"], h, lc["ffn"], cfg, mesh=mesh,
                                              rules=rules)
            nc["ffn"] = {"shift": c["shift"]}
        else:
            raise ValueError(ffn)
        x = x + y
        new_cache[f"l{li}"] = nc
    return x, new_cache


# ---------------------------------------------------------------------------
# The model as an nn.Module
# ---------------------------------------------------------------------------
class _Tree(nn.Module):
    """One level of the parameter tree: tensors as frozen parameters,
    subtrees as child modules, so state-dict keys are the tree's paths."""

    def __init__(self, tree: dict):
        super().__init__()
        self.keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        return {k: (self._modules[k].tree() if k in self._modules else self._parameters[k])
                for k in self.keys}


class LM(nn.Module):
    """A model of ``cfg`` holding its stacked parameters (keys such as
    ``decoder.l0.mixer.wq``) and calling the functions of this module."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = _Tree(params)

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0, device=None) -> "LM":
        """Random parameters from :func:`~repro_torch.models.params.init_params`
        on ``device`` (``cuda`` unless the caller passes another)."""
        return cls(cfg, init_params(model_defs(cfg), seed, device))

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, batch):
        return forward(self.tree(), batch, self.cfg)

    def prefill(self, batch, max_seq=None):
        return prefill(self.tree(), batch, self.cfg, max_seq=max_seq)

    def decode_step(self, caches, token, pos):
        return decode_step(self.tree(), caches, token, pos, self.cfg)
