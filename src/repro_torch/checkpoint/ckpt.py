"""Checkpoints: atomic, async-capable, resumable, keep-last-k (port of
``repro.checkpoint.ckpt``).

Format: one ``.npz`` per checkpoint holding every leaf of a state tree
(named by its path, as the JAX package names it: dict keys and sequence
indices as they are, a named tuple's fields as ``.field``, joined by
``//``) and a JSON sidecar with the step and the caller's metadata, so
that either package restores the other's files.  Each file is written to
a temp file, then ``os.replace``d (atomic on POSIX), so a crash mid-save
never corrupts the latest checkpoint.

A state tree is any nesting of dicts, named tuples (``EngineState``,
``PackedEngineState``), tuples and lists whose leaves are
``torch.Tensor``, numpy arrays (the threefry keys), Python scalars or
None.  :func:`restore` rebuilds the template's structure and puts each
leaf back on the template leaf's device and dtype, so a state saved from
the card restores onto the card.

On a mesh (a :class:`CheckpointManager` given ``shardings``: a tree like
the state of :class:`~repro_torch.sharding.NamedSharding`, each leaf's
placement on a running mesh) the state is every rank's blocks.  Saving is
collective: each leaf is all-gathered whole (``sharding.unshard``), one
at a time, and rank 0 alone writes the joined state, in the one-file
format above — the same file restores at ``mesh=None``, onto another
mesh or in the JAX package.  Restoring reads the file on every rank (its
directory shared) and cuts each leaf's block as it is read.
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
        return list(zip(("." + f for f in tree._fields), tree))
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


def _gather_flat(tree, shardings) -> Dict[str, np.ndarray]:
    """Each leaf of a state's blocks all-gathered whole, one at a time
    (collective); rank 0 keeps the host copies, the other ranks none."""
    from ..sharding import unshard

    flat: Dict[str, np.ndarray] = {}
    places = dict(_leaves(shardings))
    for name, leaf in _leaves(tree):
        if leaf is None:
            continue
        ns = places[name]
        whole = unshard(ns.mesh, leaf, ns.spec)
        if ns.mesh.rank == 0:
            flat[name] = _host(whole)
        del whole
    return flat


class _Blocks:
    """An ``.npz`` read leaf by leaf, each array cut to this rank's block
    of its placement as it is read."""

    def __init__(self, z, shardings):
        self._z, self._places = z, dict(_leaves(shardings))

    def __contains__(self, name) -> bool:
        return name in self._z.files

    def __getitem__(self, name) -> np.ndarray:
        from ..sharding import block

        ns = self._places[name]
        return block(ns.mesh, torch.from_numpy(self._z[name]), ns.spec).numpy()


def restore(directory: str, template, step: Optional[int] = None, *, shardings=None):
    """(tree, meta) of checkpoint ``step`` (default: the latest); ``template``
    gives the structure and each leaf's device and dtype.  With
    ``shardings`` (a tree like the template of NamedShardings on a running
    mesh) each leaf comes back as this rank's block of it."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = _ckpt_path(directory, step)
    with np.load(path) as z:
        if shardings is None:
            tree = _unflatten(template, {k: z[k] for k in z.files})
        else:
            tree = _unflatten(template, _Blocks(z, shardings))
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
    """Save every k-th step, keep the last n, write asynchronously, resume.

    ``shardings`` (a tree like the state of NamedShardings on a running
    mesh) makes it a mesh's manager: every rank calls it with its blocks,
    saving gathers them and rank 0 writes, restoring cuts each rank's
    blocks (see the module's docstring)."""

    directory: str
    save_interval: int = 100
    keep: int = 3
    async_save: bool = True
    shardings: Any = None
    _pending: Optional[threading.Thread] = None

    def _mesh(self):
        return next(ns for _, ns in _leaves(self.shardings)).mesh

    def _writer(self) -> bool:
        return self.shardings is None or self._mesh().rank == 0

    def due(self, step: int) -> bool:
        """Whether :meth:`maybe_save` writes at ``step``."""
        return step % self.save_interval == 0

    def maybe_save(self, step: int, tree, meta=None) -> bool:
        if not self.due(step):
            return False
        self.wait()
        flat = _flatten(tree) if self.shardings is None else _gather_flat(tree, self.shardings)
        if not self._writer():
            return True
        if self.async_save:
            self._pending = threading.Thread(target=_write,
                                             args=(self.directory, step, flat, meta))
            self._pending.start()
        else:
            _write(self.directory, step, flat, meta)
        self._gc()
        return True

    def latest(self) -> Optional[int]:
        """The latest checkpoint's step (None: none), once this manager's
        pending write is done; on a mesh after every rank's (a barrier), so
        that all ranks see the same files."""
        self.wait()
        if self.shardings is not None:
            self._mesh().barrier()
        return latest_step(self.directory)

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
        return restore(self.directory, template, shardings=self.shardings)

    def purge(self):
        self.wait()
        purge(self.directory)
