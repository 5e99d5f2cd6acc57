"""Spin-mesh builders for the launchers (port of the spin half of
``repro.launch.mesh``).

:func:`make_spin_mesh` turns a ``--mesh-shape`` flag into a
:class:`~repro_torch.sharding.SpinMesh`.  Under ``torchrun`` the process
group comes from the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``), one rank per process:

    torchrun --nproc-per-node 2 -m repro_torch.launch.anneal --problem K2000 \\
        --partition spin --backend dense --field-mode popcount

A single process can only make a one-rank mesh: asking it for more raises
and names ``torchrun``.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

__all__ = ["parse_mesh_shape", "make_spin_mesh"]


def parse_mesh_shape(spec: str) -> Tuple[int, ...]:
    """'8' → (8,); '2x16x16' → (2, 16, 16).  'x' or ',' separated."""
    parts = [p for p in spec.replace(",", "x").split("x") if p]
    if not parts:
        raise ValueError(f"empty mesh shape {spec!r}")
    try:
        shape = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"bad mesh shape {spec!r}; want e.g. '8' or '2x16'") from None
    if any(d < 1 for d in shape):
        raise ValueError(f"mesh shape {spec!r} has non-positive dims")
    return shape


def make_spin_mesh(spec: Optional[str] = None, *, axis: str = "model", device=None):
    """The 1-D spin mesh of a ``--mesh-shape`` value (None or '': every
    rank).  Joins the ``torchrun`` process group the environment describes
    (NCCL on ``cuda``, gloo on ``cpu``) if none is running yet."""
    import torch
    import torch.distributed as dist

    from repro_torch.sharding import spin_mesh

    n = None
    if spec:
        shape = parse_mesh_shape(spec)
        if len(shape) != 1:
            raise ValueError(f"--partition spin|auto wants a 1-D mesh, got shape {shape}")
        n = shape[0]
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and world > 1:
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    have = dist.get_world_size() if dist.is_initialized() else 1
    if n is not None and n > have:
        raise ValueError(
            f"--mesh-shape {spec} needs {n} ranks and {have} are running; start them "
            f"with torchrun --nproc-per-node {n} -m repro_torch.launch.anneal ...")
    return spin_mesh(n, axis=axis, device=device)
