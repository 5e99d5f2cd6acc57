"""Deterministic synthetic token pipeline: stateless, shardable, resumable.

Port of ``repro.data.pipeline``.  Every batch is a pure function of (seed,
step), so the pipeline's whole state is one integer cursor, and a run
resumed from a checkpoint replays the same batches.  The draws are
``jax.random``'s (``core/rng.py``: ``fold_in``, ``split``, ``randint``,
``bernoulli`` and ``normal``), so tokens, labels and the frontend stubs'
embeddings equal the JAX package's bit for bit, on whichever device the
caller names.

The token stream mixes a structured component, t_{i+1} = (31·t_0 + 97·i)
mod V, with uniform noise on a quarter of the positions, so the LM loss
falls (the example trainer and the fault-tolerance tests rely on it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core import rng

__all__ = ["DataConfig", "synthetic_batch", "host_slice", "batch_spec"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # frontends (stubs)
    n_patches: int = 0
    d_model: int = 0
    n_frames: int = 0


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("synthetic_batch: a CUDA device was requested but "
                           "torch.cuda.is_available() is False; pass device='cpu'")
    return dev


def synthetic_batch(cfg: DataConfig, step: int, device=None) -> Dict[str, torch.Tensor]:
    """The batch of ``step`` on ``device`` (``cuda`` unless the caller
    passes another): tokens (B, S+1) shifted into int32 ``tokens`` and
    ``labels`` (B, S), and float32 ``patches`` / ``frames`` where the
    config has them."""
    dev = _device(device)
    key = rng.fold_in(rng.PRNGKey(cfg.seed), step)
    k1, k2, k3, k4 = rng.split(key, 4)
    B, S = cfg.global_batch, cfg.seq_len
    a = 31 % cfg.vocab
    t0 = rng.randint(k1, (B, 1), 0, cfg.vocab, device=dev)
    idx = torch.arange(S + 1, dtype=torch.int32, device=dev)
    structured = (t0 * a + idx * 97) % cfg.vocab
    noise = rng.randint(k2, (B, S + 1), 0, cfg.vocab, device=dev)
    use_noise = rng.bernoulli(k3, 0.25, (B, S + 1), device=dev)
    tokens = torch.where(use_noise, noise, structured).to(torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.n_patches:
        batch["patches"] = rng.normal(k4, (B, cfg.n_patches, cfg.d_model), device=dev) * 0.02
    if cfg.n_frames:
        batch["frames"] = rng.normal(k4, (B, cfg.n_frames, cfg.d_model), device=dev) * 0.1
    return batch


def host_slice(batch: Dict[str, torch.Tensor], process_index: int, process_count: int):
    """Per-host shard of a global batch (multi-host data loading): rows
    ``process_index · B/P`` to ``(process_index + 1) · B/P``."""
    def slc(x):
        per = x.shape[0] // process_count
        return x[process_index * per: (process_index + 1) * per]

    return {k: slc(v) for k, v in batch.items()}


def batch_spec(cfg: DataConfig) -> Dict[str, torch.Tensor]:
    """Meta-device tensors of a batch's shapes and dtypes (no storage)."""
    B, S = cfg.global_batch, cfg.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    spec = {"tokens": meta((B, S), torch.int32), "labels": meta((B, S), torch.int32)}
    if cfg.n_patches:
        spec["patches"] = meta((B, cfg.n_patches, cfg.d_model), torch.float32)
    if cfg.n_frames:
        spec["frames"] = meta((B, cfg.n_frames, cfg.d_model), torch.float32)
    return spec
