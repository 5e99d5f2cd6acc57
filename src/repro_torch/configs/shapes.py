"""The input-shape cells and their applicability rules (port of
``repro.configs.shapes``).

  train_4k     seq_len=4,096    global_batch=256   (training)
  prefill_32k  seq_len=32,768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32,768   global_batch=128   (inference-decode)
  long_500k    seq_len=524,288  global_batch=1     (long-context decode)

decode_*/long_* are one decode step (a new token against a KV cache of
seq_len).  long_500k needs sub-quadratic decode state: it applies to the
SSM/hybrid archs only.  The ``*_input_specs`` functions give each cell's
inputs as meta-device tensors (shapes and dtypes, no storage), as
``models.params.param_shapes`` gives the parameters; the dry-run
(``launch/lowering.py``) reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

__all__ = ["ShapeCell", "SHAPES", "applicable", "train_input_specs",
           "prefill_input_specs", "decode_input_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: ShapeCell) -> Tuple[bool, str]:
    """(runnable, reason-if-not) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 500k-token decode needs sub-quadratic "
            "state (run for SSM/hybrid only) — see DESIGN.md §Arch-applicability"
        )
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg, batch: int):
    extra = {}
    if cfg.frontend == "vision" and cfg.n_patches:
        extra["patches"] = _meta((batch, cfg.n_patches, cfg.d_model), torch.float32)
    if cfg.encoder_layers > 0:
        extra["frames"] = _meta((batch, cfg.n_frames, cfg.d_model), torch.float32)
    return extra


def train_input_specs(cfg, shape: ShapeCell):
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
        **_frontend_specs(cfg, B),
    }


def prefill_input_specs(cfg, shape: ShapeCell):
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": _meta((B, S), torch.int32),
        **_frontend_specs(cfg, B),
    }


def decode_input_specs(cfg, shape: ShapeCell):
    """(token, pos) — the caches come from ``models.cache_defs``."""
    return {
        "token": _meta((shape.global_batch,), torch.int32),
        "pos": _meta((), torch.int32),
    }
