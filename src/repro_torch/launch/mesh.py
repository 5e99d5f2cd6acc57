"""Mesh builders for the launchers and the annealer (port of
``repro.launch.mesh``).

:func:`make_mesh` lays an N-D :class:`~repro_torch.sharding.Mesh` over the
ranks of the running process group (a one-rank group on an in-process
store when none runs and one rank is asked for), and fails with the
requested and running counts when they differ;
:func:`make_production_mesh` (16 × 16, or 2 × 16 × 16 over ``("pod",
"data", "model")``) and :func:`make_shrunken_mesh` (8 × 16) are presets
over it.  On one card they raise, as the JAX package's do on a
workstation; :func:`repro_torch.sharding.abstract_mesh` of their shapes is
what the dry-run lowerings analyse instead.

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

import math
import os
from typing import Optional, Sequence, Tuple

__all__ = ["parse_mesh_shape", "make_mesh", "make_spin_mesh", "make_production_mesh",
           "make_shrunken_mesh"]


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


def _join_torchrun(device) -> None:
    """Join the process group ``torchrun`` describes in the environment:
    NCCL on ``cuda`` (this process's card: ``LOCAL_RANK``), gloo on ``cpu``."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None):
    """A :class:`~repro_torch.sharding.Mesh` of ``shape`` over ``axes``,
    spanning every rank of the running process group.

    ``device`` is ``cuda`` unless the caller passes another (``'cpu'``):
    NCCL on the card, gloo on the CPU, and no fallback.  Under ``torchrun``
    it joins the group the environment describes.  A shape that needs
    more ranks than are running raises ValueError naming both counts (the
    usual failure: a pod preset started as one process); so does one that
    needs fewer, since a mesh spans the whole group."""
    import torch.distributed as dist

    from repro_torch import sharding

    shape, axes = tuple(int(d) for d in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} rank != axes {axes}")
    if any(d < 1 for d in shape):
        raise ValueError(f"mesh shape {shape} has non-positive dims")
    need = math.prod(shape)
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        _join_torchrun(device)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if need > have:
        raise ValueError(
            f"mesh shape {shape} needs {need} ranks but only {have} exist; start {need} "
            "ranks with torchrun (or join a group of them with "
            "torch.distributed.init_process_group), or shrink the mesh")
    if need < have:
        raise ValueError(f"mesh shape {shape} needs {need} ranks but {have} are running; "
                         "a mesh spans the whole process group")
    dev = sharding._requested_device("make_mesh", device)
    if not dist.is_initialized():
        sharding._join_one_rank(dev)
    backend, dev = sharding._rank_device("make_mesh", dev)
    rank = dist.get_rank()
    return sharding.Mesh(axes, shape, rank, dev, backend, sharding.axis_groups(shape, rank))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 × 16 = 256 ranks over ``("data", "model")``; 2 × 16 × 16 = 512
    over ``("pod", "data", "model")`` multi-pod."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device=device)
    return make_mesh((16, 16), ("data", "model"), device=device)


def make_shrunken_mesh(*, device=None):
    """The elastic-degraded mesh (half a pod lost): 8 × 16 = 128 ranks."""
    return make_mesh((8, 16), ("data", "model"), device=device)


def make_spin_mesh(spec: Optional[str] = None, *, axis: str = "model", device=None):
    """The 1-D spin mesh of a ``--mesh-shape`` value (None or '': every
    rank).  Joins the ``torchrun`` process group the environment describes
    (NCCL on ``cuda``, gloo on ``cpu``) if none is running yet."""
    import torch.distributed as dist

    from repro_torch.sharding import spin_mesh

    n = None
    if spec:
        shape = parse_mesh_shape(spec)
        if len(shape) != 1:
            raise ValueError(f"--partition spin|auto wants a 1-D mesh, got shape {shape}")
        n = shape[0]
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        _join_torchrun(device)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if n is not None and n > have:
        raise ValueError(
            f"--mesh-shape {spec} needs {n} ranks and {have} are running; start them "
            f"with torchrun --nproc-per-node {n} -m repro_torch.launch.anneal ...")
    return spin_mesh(n, axis=axis, device=device)
