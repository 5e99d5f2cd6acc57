"""LM serving: prefill and decode steps and a batched greedy / temperature
sampler (port of ``repro.serve.lm``).

``generate`` prefills the prompt batch, then decodes one token a step
against the caches.  At temperature > 0 a token is drawn as
``jax.random.categorical`` draws it (jax 0.9): ``argmax(gumbel + logits /
T)`` with gumbel = ``-log(-log(u))``, ``u`` = ``uniform(key, minval=tiny,
maxval=1)`` — threefry bits from :mod:`repro_torch.core.rng` and XLA's
float32 logarithm from :mod:`repro_torch.core.xla_math`, so the same float32
logits and seed give the JAX package's tokens.

On a mesh (``data`` × ``model``, or ``pod`` × ``data`` × ``model``, of the
attention + MLP families; see :mod:`repro_torch.models.transformer`) every
rank calls ``generate`` with its parameter blocks and the whole prompt
batch, runs its batch rows, and returns every row's tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core import rng
from ..core.xla_math import xla_log
from ..models import transformer as T
from ..models.params import tree_map
from ..sharding import (DEFAULT_RULES, ShardingRules, all_gather, axis_index, logical_to_spec,
                        mesh_axis_size)

__all__ = ["ServeConfig", "make_prefill_step", "make_decode_step", "generate"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int
    temperature: float = 0.0  # 0 → greedy
    eos_id: int = -1          # -1 → never stop early


def make_prefill_step(model_cfg, mesh=None, rules: ShardingRules = DEFAULT_RULES,
                      max_seq: Optional[int] = None):
    def prefill_step(params, batch):
        return T.prefill(params, batch, model_cfg, mesh=mesh, rules=rules, max_seq=max_seq)

    return prefill_step


def make_decode_step(model_cfg, mesh=None, rules: ShardingRules = DEFAULT_RULES,
                     max_seq: Optional[int] = None):
    """The decode step; on a mesh ``max_seq`` is the caches' whole length."""
    def decode_step(params, caches, token, pos):
        return T.decode_step(params, caches, token, pos, model_cfg, mesh=mesh, rules=rules,
                             max_seq=max_seq)

    return decode_step


def _gumbel(key, shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default ('low') mode."""
    tiny = float(torch.finfo(torch.float32).tiny)
    u = rng.uniform(key, shape, minval=tiny, maxval=1.0, device=device)
    return -xla_log(-xla_log(u))


def _sample(logits: torch.Tensor, key, temperature: float, rows=None) -> torch.Tensor:
    """Greedy argmax at temperature <= 0, else ``jax.random.categorical(key,
    logits / temperature)``; int32 tokens.  Both argmaxes take the first
    maximal index.  ``rows`` = (first, whole batch): ``logits`` are those
    rows of the batch, and take those rows of the whole batch's draw."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.to(torch.float32) / torch.tensor(temperature, dtype=torch.float32)
    first, whole = rows or (0, logits.shape[0])
    g = _gumbel(key, (whole,) + tuple(logits.shape[1:]), logits.device)
    return torch.argmax(g[first: first + logits.shape[0]] + scaled, dim=-1).to(torch.int32)


def _on_device(tree, dev):
    return tree_map(lambda t: torch.as_tensor(t).to(dev), tree)


def _batch_axes(mesh, rules, B: int):
    """The mesh axes the batch rows are cut over (a tuple, outermost first)."""
    spec = logical_to_spec(mesh, (B,), ("batch",), rules)
    if not spec:
        return ()
    return spec[0] if isinstance(spec[0], tuple) else (spec[0],)


@torch.no_grad()
def generate(
    params,
    batch: Dict[str, torch.Tensor],
    model_cfg,
    serve_cfg: ServeConfig,
    n_new_tokens: int,
    *,
    mesh=None,
    rules: ShardingRules = DEFAULT_RULES,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Prefill the prompt batch, then decode ``n_new_tokens`` tokens.

    Returns (B, n_new_tokens) int32.  Runs on ``device`` (``cuda`` unless
    the caller passes another); parameters and inputs are moved there (a
    tensor already there is not copied).  The key chain is the reference's:
    ``key = PRNGKey(seed)`` split once before the first token and once
    before each later one.

    On a mesh (its device is the rank's; ``device`` must be None or agree)
    ``params`` are this rank's blocks (``convert.lm_params_block``) and
    ``batch`` the whole prompt batch: the rank cuts its rows, and the
    tokens of every row are gathered, the same on every rank.
    """
    if mesh is not None:
        T.check_mesh(model_cfg, mesh, rules, "generate")
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"generate: device={device!r} differs from the mesh's {mesh.device}")
        dev = mesh.device
    else:
        dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("generate: a CUDA device was requested but "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    params, batch = _on_device(params, dev), _on_device(batch, dev)
    B, S = batch["tokens"].shape
    if S + n_new_tokens > serve_cfg.max_seq:
        raise ValueError(f"generate: a prompt of {S} and {n_new_tokens} new tokens "
                         f"exceed max_seq {serve_cfg.max_seq}")
    rows = None
    if mesh is not None:
        axes = _batch_axes(mesh, rules, B)
        n_b = B // mesh_axis_size(mesh, axes)
        rows = (axis_index(mesh, axes) * n_b, B)
        batch = {k: v[rows[0]: rows[0] + n_b] for k, v in batch.items()}
    prefill_step = make_prefill_step(model_cfg, mesh, rules, max_seq=serve_cfg.max_seq)
    decode = make_decode_step(model_cfg, mesh, rules, max_seq=serve_cfg.max_seq)

    logits, caches = prefill_step(params, batch)
    key = rng.PRNGKey(seed)
    key, k0 = rng.split(key)
    token = _sample(logits, k0, serve_cfg.temperature, rows)
    out = [token]
    pos = S
    for _ in range(n_new_tokens - 1):
        logits, caches = decode(params, caches, token, pos)
        key, ki = rng.split(key)
        token = _sample(logits, ki, serve_cfg.temperature, rows)
        out.append(token)
        pos += 1
    tokens = torch.stack(out, dim=1)
    if mesh is not None:
        for a in reversed(axes):  # the innermost axis first: rows come back in order
            tokens = all_gather(mesh, tokens, 0, a)
    return tokens.cpu().numpy()
