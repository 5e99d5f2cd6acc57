"""RWKV-6 (Finch) block: time mix with data-dependent decay, channel mix.

Port of ``repro.models.rwkv``.  Per head (dim D), state S ∈ R^{D×D}; for
each token t:

    S_t  = diag(w_t) · S_{t-1} + k_tᵀ ⊗ v_t
    y_t  = r_t · (S_{t-1} + diag(u) · k_tᵀ ⊗ v_t)

with r, k, v, g from token-shifted projections and the data-dependent decay
w_t = exp(-exp(w0 + tanh(x W_w1) W_w2)) (arXiv:2404.05892).  Channel mix is
the squared-ReLU FFN.  The reference's simplifications are kept: the
token-shift interpolation is a per-channel learned μ (the RWKV-5 form), the
decay LoRA is kept.  The WKV recurrence is a Python loop over the sequence
(the reference's ``lax.scan``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..sharding import DEFAULT_RULES, ShardingRules, constrain, unported_on_mesh
from .layers import COMPUTE_DTYPE, F32, mm, mm_cd, rms_norm, silu
from .params import ParamDef

__all__ = ["rwkv_defs", "rwkv_time_mix", "rwkv_time_mix_decode",
           "rwkv_channel_defs", "rwkv_channel_mix", "rwkv_channel_mix_decode",
           "rwkv_init_cache"]

_DECAY_LORA = 64


def _dims(cfg):
    H = cfg.d_model // cfg.rwkv_head_dim
    return H, cfg.rwkv_head_dim


def rwkv_defs(cfg) -> Dict[str, ParamDef]:
    M = cfg.d_model
    H, D = _dims(cfg)
    L = _DECAY_LORA
    return {
        "mu_r": ParamDef((M,), ("d_model",), init="ones", scale=0.5),
        "mu_k": ParamDef((M,), ("d_model",), init="ones"),
        "mu_v": ParamDef((M,), ("d_model",), init="ones"),
        "mu_g": ParamDef((M,), ("d_model",), init="ones"),
        "mu_w": ParamDef((M,), ("d_model",), init="ones"),
        "wr": ParamDef((M, H, D), ("d_model", "heads", "d_head")),
        "wk": ParamDef((M, H, D), ("d_model", "heads", "d_head")),
        "wv": ParamDef((M, H, D), ("d_model", "heads", "d_head")),
        "wg": ParamDef((M, H, D), ("d_model", "heads", "d_head")),
        "w0": ParamDef((H, D), ("heads", "d_head"), init="zeros"),
        "w_lora_a": ParamDef((M, L), ("d_model", None), scale=0.02),
        "w_lora_b": ParamDef((L, H, D), (None, "heads", "d_head"), scale=0.02),
        "u_bonus": ParamDef((H, D), ("heads", "d_head"), init="zeros"),
        "ln_scale": ParamDef((H, D), ("heads", "d_head"), init="ones"),
        "wo": ParamDef((H, D, M), ("heads", "d_head", "d_model")),
    }


def _shift(x, x_prev):
    """Token shift: the previous token (the carry) before x[:-1]."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x * mu + xs * (1.0 - mu)


def _time_mix_projections(p, x, xs, cfg):
    """x, xs (B,S,M) float32 → r,k,v,g (B,S,H,D), w (B,S,H,D) decay in (0,1)."""
    xr = _mix(x, xs, p["mu_r"].to(F32))
    xk = _mix(x, xs, p["mu_k"].to(F32))
    xv = _mix(x, xs, p["mu_v"].to(F32))
    xg = _mix(x, xs, p["mu_g"].to(F32))
    xw = _mix(x, xs, p["mu_w"].to(F32))
    r = mm_cd(xr, p["wr"]).to(F32)
    k = mm_cd(xk, p["wk"]).to(F32)
    v = mm_cd(xv, p["wv"]).to(F32)
    g = mm_cd(xg, p["wg"]).to(F32)
    lora = torch.tanh(mm(xw, p["w_lora_a"].to(F32)))
    dd = mm(lora, p["w_lora_b"].to(F32))
    w = torch.exp(-torch.exp(p["w0"].to(F32) + dd))
    return r, k, v, g, w


def _wkv_scan(r, k, v, w, u, s0):
    """WKV6 recurrence.  r,k,v,w (B,S,H,D); u (H,D); s0 (B,H,D,D).

    Returns (y (B,S,H,D), s_final).  State layout: S[d_k, d_v].
    """
    s = s0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B,H,D)
        kv = kt[..., :, None] * vt[..., None, :]              # (B,H,Dk,Dv)
        ys.append(torch.matmul(rt[..., None, :], s + u[..., None] * kv)[..., 0, :])
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv_time_mix(
    p,
    x,  # (B, S, M)
    cfg,
    *,
    mesh=None,
    rules: ShardingRules = DEFAULT_RULES,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    unported_on_mesh(mesh, "rwkv_time_mix", ".3")
    B, S, M = x.shape
    H, D = _dims(cfg)
    xf = x.to(F32)
    if cache is None:
        x_prev = torch.zeros((B, M), dtype=F32, device=x.device)
        s0 = torch.zeros((B, H, D, D), dtype=F32, device=x.device)
    else:
        x_prev, s0 = cache["shift"].to(F32), cache["wkv"].to(F32)
    xs = _shift(xf, x_prev)
    r, k, v, g, w = _time_mix_projections(p, xf, xs, cfg)
    y, s_fin = _wkv_scan(r, k, v, w, p["u_bonus"].to(F32), s0)
    # per-head group norm, then the gate
    y = rms_norm(y, p["ln_scale"])
    y = (y.to(F32) * silu(g)).to(COMPUTE_DTYPE)
    out = mm_cd(y, p["wo"], 2)
    new_cache = {"shift": xf[:, -1].to(COMPUTE_DTYPE), "wkv": s_fin}
    return constrain(out, mesh, ("batch", "seq", "d_model"), rules), new_cache


def rwkv_time_mix_decode(p, x, cache, cfg, *, mesh=None, rules=DEFAULT_RULES):
    """x (B,1,M); cache {"shift": (B,M), "wkv": (B,H,D,D)}."""
    return rwkv_time_mix(p, x, cfg, mesh=mesh, rules=rules, cache=cache)


# ---------------------------------------------------------------------------
# Channel mix (the RWKV FFN): r gate, squared-relu key
# ---------------------------------------------------------------------------
def rwkv_channel_defs(cfg) -> Dict[str, ParamDef]:
    M, F_ = cfg.d_model, cfg.d_ff
    return {
        "mu_r": ParamDef((M,), ("d_model",), init="ones"),
        "mu_k": ParamDef((M,), ("d_model",), init="ones"),
        "wr": ParamDef((M, M), ("d_model", None), scale=0.02),
        "wk": ParamDef((M, F_), ("d_model", "d_ff")),
        "wv": ParamDef((F_, M), ("d_ff", "d_model")),
    }


def rwkv_channel_mix(
    p, x, cfg, *, mesh=None, rules=DEFAULT_RULES, cache=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    unported_on_mesh(mesh, "rwkv_channel_mix", ".3")
    B, S, M = x.shape
    cd = COMPUTE_DTYPE
    xf = x.to(F32)
    x_prev = (torch.zeros((B, M), dtype=F32, device=x.device) if cache is None
              else cache["shift"].to(F32))
    xs = _shift(xf, x_prev)
    xr = _mix(xf, xs, p["mu_r"].to(F32))
    xk = _mix(xf, xs, p["mu_k"].to(F32))
    r = torch.sigmoid(mm_cd(xr, p["wr"]).to(F32))
    k = torch.square(torch.relu(mm_cd(xk, p["wk"]).to(F32)))
    v = mm_cd(k, p["wv"])
    out = (r * v.to(F32)).to(cd)
    new_cache = {"shift": xf[:, -1].to(cd)}
    return constrain(out, mesh, ("batch", "seq", "d_model"), rules), new_cache


def rwkv_channel_mix_decode(p, x, cache, cfg, *, mesh=None, rules=DEFAULT_RULES):
    return rwkv_channel_mix(p, x, cfg, mesh=mesh, rules=rules, cache=cache)


def rwkv_init_cache(cfg, batch: int, dtype=COMPUTE_DTYPE, device=None):
    H, D = _dims(cfg)
    return {
        "time": {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
                 "wkv": torch.zeros((batch, H, D, D), dtype=F32, device=device)},
        "channel": {"shift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)},
    }
