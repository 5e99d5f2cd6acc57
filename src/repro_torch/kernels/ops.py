"""Public kernel entry points (port of ``repro.kernels.ops``).

``repro_torch.core.engine.CudaBackend`` takes its per-cycle field from
:func:`local_field` when a plateau must emit per-cycle outputs.
"""
from __future__ import annotations

import torch

from . import ssa_update

__all__ = ["local_field"]


def local_field(m: torch.Tensor, h: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Dense field backend of the cuda engine: h + m @ J, int32 (kernel K3)."""
    return ssa_update.local_field(m, h, J)
