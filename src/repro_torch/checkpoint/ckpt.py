"""Checkpoints: atomic, async-capable, resumable, keep-last-k (port of
``repro.checkpoint.ckpt``).

Format: one ``.npz`` per checkpoint holding every leaf of a state tree
(named by its path) and a JSON sidecar with the step and the caller's
metadata.  Each file is written to a temp file, then ``os.replace``d
(atomic on POSIX), so a crash mid-save never corrupts the latest
checkpoint.

A state tree is any nesting of dicts, named tuples (``EngineState``,
``PackedEngineState``), tuples and lists whose leaves are
``torch.Tensor``, numpy arrays (the threefry keys), Python scalars or
None.  :func:`restore` rebuilds the template's structure and puts each
leaf back on the template leaf's device and dtype, so a state saved from
the card restores onto the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "save",
    "save_async",
    "restore",
    "latest_step",
    "purge",
    "CheckpointManager",
]

_SEP = "//"


def _items(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def _leaves(tree, prefix=()):
    """(path name, leaf) of every leaf, in a fixed order."""
    items = _items(tree)
    if items is None:
        yield _SEP.join(map(str, prefix)), tree
        return
    for k, child in items:
        yield from _leaves(child, prefix + (k,))


def _host(leaf) -> Optional[np.ndarray]:
    """A host copy of one leaf, taken now: a CUDA tensor is copied by
    ``.cpu()``, a CPU tensor or array is copied explicitly, so a later
    in-place write to the source cannot reach the checkpoint."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        a = leaf.detach()
        return a.cpu().numpy() if a.device.type != "cpu" else a.numpy().copy()
    return np.array(leaf, copy=True)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {name: _host(leaf) for name, leaf in _leaves(tree) if leaf is not None}


def _like(template, arr: np.ndarray):
    """``arr`` as the template leaf's kind: a tensor on its device and
    dtype, an array of its dtype, or a Python scalar."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=template.device, dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(arr, dtype=template.dtype)
    if isinstance(template, (bool, int, float)):
        return type(template)(arr.item())
    return arr


def _unflatten(template, flat: Dict[str, np.ndarray], prefix=()):
    items = _items(template)
    if items is None:
        if template is None:
            return None
        name = _SEP.join(map(str, prefix))
        if name not in flat:
            raise KeyError(f"checkpoint missing leaf {name}")
        return _like(template, flat[name])
    children = [_unflatten(child, flat, prefix + (k,)) for k, child in items]
    if isinstance(template, dict):
        return dict(zip(template.keys(), children))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*children)
    return type(template)(children)


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def _write(directory: str, step: int, flat: Dict[str, np.ndarray], meta) -> str:
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)  # atomic
    meta = dict(meta or {})
    meta["step"] = step
    mpath = path.replace(".npz", ".json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(mpath + ".tmp", mpath)
    return path


def save(directory: str, step: int, tree, meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as checkpoint ``step`` of ``directory``; returns its path."""
    return _write(directory, step, _flatten(tree), meta)


def save_async(directory: str, step: int, tree, meta=None) -> threading.Thread:
    """Copy the tree to the host now, write it to disk on a thread."""
    flat = _flatten(tree)  # device → host before the thread starts
    t = threading.Thread(target=_write, args=(directory, step, flat, meta))
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(directory)
             if (m := re.fullmatch(r"ckpt_(\d+)\.npz", fn))]
    return max(steps) if steps else None


def restore(directory: str, template, step: Optional[int] = None):
    """(tree, meta) of checkpoint ``step`` (default: the latest); ``template``
    gives the structure and each leaf's device and dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = _ckpt_path(directory, step)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(template, flat)
    with open(path.replace(".npz", ".json")) as f:
        meta = json.load(f)
    return tree, meta


def purge(directory: str):
    """Remove every checkpoint (with its sidecar and temp files) of
    ``directory``, and the directory if that leaves it empty.

    The annealing service purges a group's chunk checkpoints once the group
    completes, so a later identical solve starts fresh instead of resuming
    a finished run.  Only checkpoint-shaped files are touched.
    """
    if not os.path.isdir(directory):
        return
    for fn in os.listdir(directory):
        if re.fullmatch(r"ckpt_\d+\.(npz|json)(\.tmp)?", fn):
            try:
                os.remove(os.path.join(directory, fn))
            except OSError:
                pass
    try:
        os.rmdir(directory)
    except OSError:
        pass  # other files present: leave the directory


@dataclasses.dataclass
class CheckpointManager:
    """Save every k-th step, keep the last n, write asynchronously, resume."""

    directory: str
    save_interval: int = 100
    keep: int = 3
    async_save: bool = True
    _pending: Optional[threading.Thread] = None

    def due(self, step: int) -> bool:
        """Whether :meth:`maybe_save` writes at ``step``."""
        return step % self.save_interval == 0

    def maybe_save(self, step: int, tree, meta=None) -> bool:
        if not self.due(step):
            return False
        self.wait()
        if self.async_save:
            self._pending = save_async(self.directory, step, tree, meta)
        else:
            save(self.directory, step, tree, meta)
        self._gc()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(m.group(1)) for fn in os.listdir(self.directory)
                       if (m := re.fullmatch(r"ckpt_(\d+)\.npz", fn)))
        for s in steps[: -self.keep] if self.keep else []:
            for ext in (".npz", ".json"):
                try:
                    os.remove(_ckpt_path(self.directory, s).replace(".npz", ext))
                except OSError:
                    pass

    def restore_latest(self, template):
        self.wait()
        return restore(self.directory, template)

    def purge(self):
        self.wait()
        purge(self.directory)
