"""The input-shape cells and their applicability rules (port of
``repro.configs.shapes``).

  train_4k     seq_len=4,096    global_batch=256   (training)
  prefill_32k  seq_len=32,768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32,768   global_batch=128   (inference-decode)
  long_500k    seq_len=524,288  global_batch=1     (long-context decode)

decode_*/long_* are one decode step (a new token against a KV cache of
seq_len).  long_500k needs sub-quadratic decode state: it applies to the
SSM/hybrid archs only.  The ``*_input_specs`` functions feed the dry-run
analysis, which is not ported yet (ROADMAP.md queue 1, step 10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ShapeCell", "SHAPES", "applicable"]


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
