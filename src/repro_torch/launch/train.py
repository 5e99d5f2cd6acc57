"""Training launcher: ``--arch <id>`` selectable configs, checkpoint/resume,
optional HA-SSA expert placement for MoE archs.

Port of ``repro.launch.train``, with ``--device`` (default ``cuda``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --scale reduced \\
        --steps 100 --batch 8 --seq 64 [--placement ssa] [--device cpu]

``--scale full`` trains the published widths (qwen3-1.7b: 2.03e9 float32
parameters, which with their gradients, AdamW moments and remat fit one
H100).  The run resumes from ``--ckpt-dir`` if it holds a checkpoint.
``--mesh none`` runs on one device; ``single``, ``pod`` and ``shrunken``
are the reference's production meshes (``launch.mesh``: 16 × 16, 2 × 16 ×
16 and 8 × 16 ranks), one rank a card, started by ``torchrun`` with 256,
512 or 128 ranks (NCCL; ``--device cpu``: gloo):

    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch qwen3-1.7b --scale full --mesh single --batch 256 --seq 4096

Every rank builds its blocks of the state (``init_train_state``), cuts its
rows of each step's batch (``convert.lm_batch_block``) and runs the same
step; the checkpoints hold the joined state, written by rank 0.  Started
with fewer ranks, a preset raises ValueError naming both counts.
:func:`train` takes the same arguments as a list and returns the state
(this rank's blocks on a mesh), the losses and each step's figures.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from ..checkpoint.ckpt import CheckpointManager
from ..configs import ARCH_NAMES, get_config
from ..convert import lm_batch_block
from ..data.pipeline import DataConfig, synthetic_batch
from ..ft.resilience import StragglerMonitor, run_training
from ..models import model_defs
from ..models.params import param_pspecs
from ..optim.adamw import AdamWConfig
from ..sharding import DEFAULT_RULES, batch_axes, mesh_axis_size
from ..train.step import TrainConfig, init_train_state, make_train_step, train_state_shardings

__all__ = ["build_mesh", "maybe_ssa_placement", "parse_args", "run_configs", "train", "TrainRun",
           "main"]


def build_mesh(kind: str, device=None):
    """None for ``none``; else the reference's production mesh of that name
    over the running ranks (``launch.mesh.make_production_mesh`` /
    ``make_shrunken_mesh``: 256, 512 or 128 of them), on ``device``."""
    if kind == "none":
        return None
    from .mesh import make_production_mesh, make_shrunken_mesh

    if kind == "single":
        return make_production_mesh(multi_pod=False, device=device)
    if kind == "pod":
        return make_production_mesh(multi_pod=True, device=device)
    if kind == "shrunken":
        return make_shrunken_mesh(device=device)
    raise ValueError(kind)


def maybe_ssa_placement(cfg, seed: int = 0, device=None):
    """Anneal an expert→EP-rank placement from (synthetic) routing stats,
    with the port's ``core/placement.py`` on ``device``."""
    if cfg.n_experts == 0:
        print(f"--placement ssa: {cfg.name} has no experts; skipping "
              "(technique inapplicable, see DESIGN.md §Arch-applicability)")
        return None
    from ..core.placement import coactivation_stats, expert_placement

    rng = np.random.default_rng(seed)
    routing = rng.integers(0, cfg.n_experts, size=(2000, max(cfg.top_k, 1)))
    coact, load = coactivation_stats(routing, cfg.n_experts)
    n_dev = min(16, cfg.n_experts)
    res = expert_placement(coact, load, n_devices=n_dev, seed=seed, device=device)
    print(f"HA-SSA expert placement over {n_dev} EP ranks: "
          f"cost {res.baseline_cost:.0f} → {res.cost:.0f} "
          f"({100*res.improvement:.1f}% better than round-robin)")
    return res.assignment


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-1.7b")
    ap.add_argument("--scale", choices=("reduced", "full"), default="reduced")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", choices=("none", "single", "pod", "shrunken"),
                    default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--placement", choices=("none", "ssa"), default="none")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def run_configs(args: argparse.Namespace, cfg):
    """(TrainConfig, DataConfig) of a run with arguments ``args`` of ``cfg``:
    AdamW to ``--lr`` after a tenth of ``--steps`` of warm-up, the loss in
    chunks of up to 512, the synthetic batches of ``--batch`` × ``--seq``."""
    tc = TrainConfig(
        opt=AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
        microbatches=args.microbatches,
        loss_chunk=min(512, args.seq),
    )
    dc = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        n_patches=cfg.n_patches if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model,
        n_frames=cfg.n_frames if cfg.encoder_layers else 0,
    )
    return tc, dc


class TrainRun(NamedTuple):
    state: Any                        # the final TrainState
    losses: List[float]               # ce_loss of each step run
    history: List[Dict[str, float]]   # each step's metrics and times
    init_s: float                     # building the initial state (or 0 on resume)
    stragglers: List[int]


def train(argv: Optional[Sequence[str]] = None, *, log_every: int = 10) -> TrainRun:
    """The launcher's run with command-line arguments ``argv``."""
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=(args.scale == "reduced"))
    mesh = build_mesh(args.mesh, args.device)
    if mesh is not None and args.batch % mesh_axis_size(mesh, batch_axes(mesh)):
        raise ValueError(f"--batch {args.batch} is not a multiple of the "
                         f"{mesh_axis_size(mesh, batch_axes(mesh))} ranks of the batch axes")
    if args.placement == "ssa":
        maybe_ssa_placement(cfg, device=args.device)

    tc, dc = run_configs(args, cfg)
    pspecs = param_pspecs(model_defs(cfg), mesh, DEFAULT_RULES) if mesh else None
    step = make_train_step(cfg, tc, mesh=mesh, rules=DEFAULT_RULES, param_specs=pspecs)
    monitor = StragglerMonitor(n_hosts=1)
    init_s = [0.0]
    device = mesh.device if mesh is not None else args.device

    def init_state():
        t0 = time.perf_counter()
        state = init_train_state(cfg, tc, 0, device=device, mesh=mesh, param_specs=pspecs)
        float(state.opt.step)  # the state is on the device
        init_s[0] = time.perf_counter() - t0
        return state

    def batch_fn(s):
        batch = synthetic_batch(dc, s, device=device)
        return batch if mesh is None else lm_batch_block(batch, mesh.shape, mesh.coords)

    shardings = train_state_shardings(cfg, tc, mesh) if mesh is not None else None
    history: List[Dict[str, float]] = []
    state, losses = run_training(
        init_state_fn=init_state,
        train_step=step,
        batch_fn=batch_fn,
        n_steps=args.steps,
        ckpt=CheckpointManager(args.ckpt_dir, save_interval=args.ckpt_every, keep=2,
                               shardings=shardings),
        monitor=monitor,
        log_every=log_every,
        history=history,
    )
    return TrainRun(state, losses, history, init_s[0], monitor.stragglers())


def main(argv: Optional[Sequence[str]] = None):
    run = train(argv)
    if run.losses:
        print(f"done: loss {run.losses[0]:.3f} → {run.losses[-1]:.3f}; "
              f"stragglers flagged: {run.stragglers}")
    else:
        print("done: nothing to run (the checkpoint is at the last step)")
    return run


if __name__ == "__main__":
    main()
