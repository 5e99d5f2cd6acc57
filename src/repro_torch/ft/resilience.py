"""Fault tolerance of LM training: restartable runs, straggler detection,
moving a state to other devices.

Port of ``repro.ft.resilience``:

1. **Checkpoint/restart** — :func:`run_training` drives (train_step,
   batch_fn(step), CheckpointManager).  The data pipeline is a pure
   function of the step, and the checkpoint holds (params, opt, step), so a
   process killed at any point resumes bit for bit (the tests kill a run
   and compare its losses with an uninterrupted one's).

2. **Straggler detection** — :class:`StragglerMonitor` keeps an EMA of
   each host's step time and flags hosts slower than ``threshold ×`` the
   median EMA of the hosts past warm-up.  As in the reference, the step
   time it is given is taken *before* the step's loss is read: on the card,
   where the step's kernels run after the call returns, that is the time
   to issue the step, not to run it (ROADMAP.md queue 3).

3. **Re-placement** — :func:`remesh` moves a state tree leaf by leaf to
   the devices a function names, or re-shards a state's blocks onto a new
   mesh (the NamedShardings a function gives), values unchanged.  Torch
   tensors carry no placement, so the blocks' own placement on the
   running mesh is passed as ``src``.

On a mesh every rank calls :func:`run_training` with its blocks and a
:class:`~repro_torch.checkpoint.ckpt.CheckpointManager` given the state's
shardings: saving is collective, rank 0 writes the joined state, and a
resumed run restores each rank's blocks from it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.ckpt import CheckpointManager
from ..sharding import NamedSharding

__all__ = ["StragglerMonitor", "remesh", "run_training", "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    """Raised by tests to emulate a node loss mid-training."""


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    ema_decay: float = 0.9
    threshold: float = 1.5   # flag if EMA > threshold × median EMA
    warmup_steps: int = 3

    def __post_init__(self):
        self._ema = np.zeros(self.n_hosts)
        self._count = np.zeros(self.n_hosts, dtype=int)

    def record(self, host: int, step_time: float):
        if self._count[host] == 0:
            self._ema[host] = step_time
        else:
            self._ema[host] = (
                self.ema_decay * self._ema[host] + (1 - self.ema_decay) * step_time
            )
        self._count[host] += 1

    def stragglers(self) -> List[int]:
        ready = self._count >= self.warmup_steps
        if not ready.any():
            return []
        med = float(np.median(self._ema[ready]))
        if med <= 0:
            return []
        return [
            h for h in range(self.n_hosts)
            if ready[h] and self._ema[h] > self.threshold * med
        ]


# ---------------------------------------------------------------------------
# Re-placement
# ---------------------------------------------------------------------------
def _reshard(leaf, where: NamedSharding, src):
    """A leaf's block on ``where``'s mesh from its block on ``src``'s: joined
    over the old mesh (collective), cut for this rank on the new one."""
    from ..sharding import block, unshard

    if not isinstance(src, NamedSharding):
        raise ValueError("remesh onto NamedShardings needs src, the blocks' placement on the "
                         "running mesh (a matching tree of NamedSharding): a tensor carries "
                         "none")
    out = block(where.mesh, unshard(src.mesh, leaf, src.spec), where.spec)
    dev = getattr(where.mesh, "device", None)
    return out if dev is None else out.to(dev)


def _move(leaf, where, src=None):
    if isinstance(where, (str, torch.device)):
        return leaf.to(where) if isinstance(leaf, torch.Tensor) else leaf
    if isinstance(where, NamedSharding):
        return _reshard(leaf, where, src)
    raise TypeError(f"remesh: {type(where).__name__} is neither a device nor a NamedSharding")


def _map(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, *ab) for ab in zip(tree, *others)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, *ab) for ab in zip(tree, *others))
    return fn(tree, *others)


def remesh(tree, shardings_fn: Callable[[Any], Any], *, src=None):
    """Move a tree (dicts, named tuples, tuples, lists of tensors) onto
    ``shardings_fn(tree)``, a matching tree of devices (``torch.device`` or
    strings such as ``'cuda:0'``) or of NamedShardings of a new mesh.  A
    value already on its device is the same tensor.

    Onto NamedShardings the leaves are this rank's blocks on the running
    mesh, placed as ``src`` (a matching tree of NamedSharding) says; each
    leaf is gathered whole over that mesh and cut for this rank's
    coordinates on the new one (a running ``Mesh``, or an ``AbstractMesh``
    with ``rank`` set), one leaf at a time, values unchanged.  Collective
    on the running mesh."""
    where = shardings_fn(tree)
    if src is None:
        return _map(_move, tree, where)
    return _map(_move, tree, where, src)


# ---------------------------------------------------------------------------
# Restartable training driver
# ---------------------------------------------------------------------------
def run_training(
    *,
    init_state_fn: Callable[[], Any],
    train_step: Callable[[Any, Any], Tuple[Any, Dict]],
    batch_fn: Callable[[int], Any],
    n_steps: int,
    ckpt: CheckpointManager,
    fail_at_step: Optional[int] = None,
    monitor: Optional[StragglerMonitor] = None,
    log_every: int = 0,
    history: Optional[List[Dict[str, float]]] = None,
) -> Tuple[Any, List[float]]:
    """Run (or resume) training to n_steps.  Returns (state, loss history).

    Resume: if the checkpoint directory holds a saved state, start from it;
    the step counter lives in ``state.opt.step`` and the data is replayed
    from that cursor.  ``fail_at_step`` raises SimulatedFailure *after* that
    step's optimizer update but before its checkpoint would complete — the
    worst-case window.  ``history``, if given, gets one dict a step: the
    step, ``issue_s`` (the time the monitor records), ``wall_s`` (to the
    loss on the host) and the step's metrics as floats.
    """
    state = init_state_fn()
    start = 0
    if ckpt.latest() is not None:
        state, meta = ckpt.restore_latest(state)
        start = int(meta["step"])

    losses: List[float] = []
    for step in range(start, n_steps):
        t0 = time.perf_counter()
        batch = batch_fn(step)
        state, metrics = train_step(state, batch)
        dt = time.perf_counter() - t0
        if monitor is not None:
            monitor.record(0, dt)
        loss = float(metrics["ce_loss"])
        losses.append(loss)
        if history is not None:
            history.append({**{k: float(v) for k, v in metrics.items()},
                            "step": step + 1, "issue_s": dt,
                            "wall_s": time.perf_counter() - t0})
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if fail_at_step is not None and step + 1 == fail_at_step:
            raise SimulatedFailure(f"simulated node loss at step {step + 1}")
        ckpt.maybe_save(step + 1, state, meta={"data_step": step + 1})
    ckpt.wait()
    return state, losses
