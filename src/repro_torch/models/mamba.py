"""Mamba (S6 selective SSM) block — the 'mamba' layers of Jamba-1.5.

Port of ``repro.models.mamba`` (Gu & Dao 2023; Jamba arXiv:2403.19887):

  in_proj   : M → 2·d_inner  (x branch, z gate branch)
  conv1d    : depthwise causal, width d_conv, over the x branch
  selection : x → (dt_low (dt_rank), B (d_state), C (d_state));
              dt = softplus(dt_low @ W_dt + dt_bias)
  SSM       : h_t = exp(dt·A) ⊙ h_{t-1} + (dt·B_t) · x_t ;  y_t = C_t·h_t + D·x_t
  out       : (y ⊙ silu(z)) @ out_proj → M

Prefill runs the recurrence as a Python loop over the sequence (the
reference's ``lax.scan``; state (B, d_inner, N) in float32); decode is one
state update.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..sharding import DEFAULT_RULES, ShardingRules, constrain, unported_on_mesh
from .layers import COMPUTE_DTYPE, F32, mm, mm_cd, silu
from .params import ParamDef

__all__ = ["mamba_defs", "mamba", "mamba_decode", "mamba_init_cache"]


def _dims(cfg):
    d_inner = cfg.expand * cfg.d_model
    dt_rank = cfg.dt_rank or max(1, cfg.d_model // 16)
    return d_inner, dt_rank, cfg.d_state, cfg.d_conv


def mamba_defs(cfg) -> Dict[str, ParamDef]:
    M = cfg.d_model
    DI, R, N, K = _dims(cfg)
    return {
        "in_proj": ParamDef((M, 2, DI), ("d_model", None, "d_ff")),
        "conv_w": ParamDef((K, DI), (None, "d_ff"), scale=0.5),
        "conv_b": ParamDef((DI,), ("d_ff",), init="zeros"),
        "x_proj": ParamDef((DI, R + 2 * N), ("d_ff", None)),
        "dt_proj": ParamDef((R, DI), (None, "d_ff"), scale=0.1),
        "dt_bias": ParamDef((DI,), ("d_ff",), init="zeros"),
        "a_log": ParamDef((DI, N), ("d_ff", "ssm_state"), init="zeros"),
        "d_skip": ParamDef((DI,), ("d_ff",), init="ones"),
        "out_proj": ParamDef((DI, M), ("d_ff", "d_model")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _selection(p, xc, cfg):
    """xc (..., DI) → dt (..., DI), Bm (..., N), Cm (..., N), all float32."""
    DI, R, N, _ = _dims(cfg)
    proj = mm(xc.to(F32), p["x_proj"].to(F32))
    dt_low, Bm, Cm = proj[..., :R], proj[..., R: R + N], proj[..., R + N:]
    dt = softplus(mm(dt_low, p["dt_proj"].to(F32)) + p["dt_bias"].to(F32))
    return dt, Bm, Cm


def _ssm_step(h, xt, dt, Bm, Cm, A, D_skip):
    """One recurrence step.  h (B, DI, N); xt/dt (B, DI); Bm/Cm (B, N)."""
    dA = torch.exp(dt[..., None] * A)                    # (B, DI, N)
    dBx = (dt * xt)[..., None] * Bm[:, None, :]          # (B, DI, N)
    h_new = dA * h + dBx
    y = torch.matmul(h_new, Cm[:, :, None])[..., 0] + D_skip * xt
    return h_new, y


def mamba(
    p,
    x,  # (B, S, M)
    cfg,
    *,
    mesh=None,
    rules: ShardingRules = DEFAULT_RULES,
    h0: Optional[torch.Tensor] = None,
    conv0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba.  Returns (y (B,S,M), cache{conv,ssm}).  One
    device only."""
    unported_on_mesh(mesh, "mamba", ".3")
    B, S, M = x.shape
    DI, R, N, K = _dims(cfg)
    cd = COMPUTE_DTYPE
    A = -torch.exp(p["a_log"].to(F32))
    D_skip = p["d_skip"].to(F32)

    xz = mm_cd(x, p["in_proj"])         # (B,S,2,DI)
    xs, z = xz[:, :, 0], xz[:, :, 1]

    # depthwise causal conv1d, width K, summed tap by tap as the reference
    pad = (torch.zeros((B, K - 1, DI), dtype=xs.dtype, device=x.device)
           if conv0 is None else conv0.to(xs.dtype))
    xp = torch.cat([pad, xs], dim=1)   # (B, S+K-1, DI)
    conv_w = p["conv_w"].to(F32)
    xc = xp[:, 0:S].to(F32) * conv_w[0]
    for i in range(1, K):
        xc = xc + xp[:, i: i + S].to(F32) * conv_w[i]
    xc = silu(xc + p["conv_b"].to(F32))  # (B,S,DI) f32

    dt, Bm, Cm = _selection(p, xc, cfg)
    h = torch.zeros((B, DI, N), dtype=F32, device=x.device) if h0 is None else h0.to(F32)
    ys = []
    for t in range(S):
        h, y = _ssm_step(h, xc[:, t], dt[:, t], Bm[:, t], Cm[:, t], A, D_skip)
        ys.append(y)
    y = torch.stack(ys, dim=1)          # (B,S,DI)

    out = (y * silu(z.to(F32))).to(cd)
    out = mm_cd(out, p["out_proj"])
    # cache["conv"] holds the last K-1 *pre-conv* inputs
    cache = {"conv": xp[:, -(K - 1):].to(cd), "ssm": h}
    return constrain(out, mesh, ("batch", "seq", "d_model"), rules), cache


def mamba_init_cache(cfg, batch: int, dtype=COMPUTE_DTYPE, device=None):
    DI, R, N, K = _dims(cfg)
    return {
        "conv": torch.zeros((batch, K - 1, DI), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, DI, N), dtype=F32, device=device),
    }


def mamba_decode(
    p,
    x,      # (B, 1, M)
    cache,  # {"conv": (B, K-1, DI), "ssm": (B, DI, N)}
    cfg,
    *,
    mesh=None,
    rules: ShardingRules = DEFAULT_RULES,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    unported_on_mesh(mesh, "mamba_decode", ".3")
    cd = COMPUTE_DTYPE
    A = -torch.exp(p["a_log"].to(F32))
    D_skip = p["d_skip"].to(F32)

    xz = mm_cd(x, p["in_proj"])
    xs, z = xz[:, 0, 0], xz[:, 0, 1]   # (B, DI)

    window = torch.cat([cache["conv"].to(F32), xs[:, None].to(F32)], dim=1)  # (B,K,DI)
    conv_w = p["conv_w"].to(F32)
    xc = torch.sum(window * conv_w, dim=1) + p["conv_b"].to(F32)
    xc = silu(xc)

    dt, Bm, Cm = _selection(p, xc, cfg)
    h_new, y = _ssm_step(cache["ssm"].to(F32), xc, dt, Bm, Cm, A, D_skip)

    out = (y * silu(z.to(F32))).to(cd)
    out = mm_cd(out, p["out_proj"])[:, None]
    new_cache = {"conv": window[:, 1:].to(cd), "ssm": h_new}
    return constrain(out, mesh, ("batch", "seq", "d_model"), rules), new_cache
