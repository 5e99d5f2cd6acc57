"""Carry models, engine states, the iteration steps' state tuples, SA
carries, problem encodings, LM parameters and caches and LM training states
across packages as numpy arrays; and cut the iteration steps' arguments
and the LM's parameters, caches and inputs into a mesh rank's blocks and
join the blocks back.

The JAX package and this port agree on every layout, but not on dtypes:
this port carries uint32 words (xorshift lanes, packed spins) as int32
tensors.  These helpers convert at that boundary and import nothing of the
JAX package — a caller passes plain numpy arrays in and gets them out.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .core.distributed import iteration_specs
from .core.engine import BIG_ENERGY, EngineState, PackedEngineState
from .core.ising import IsingModel
from .core.sa import SACarry
from .kernels.bitplane import PackedJ
from .problems import ColoringProblem, MISProblem, PartitionProblem, QUBOProblem

__all__ = ["ising_from_arrays", "engine_state_from_arrays", "engine_state_to_arrays",
           "iteration_state_from_arrays", "iteration_state_to_arrays",
           "iteration_state_block", "iteration_state_join", "packed_j_from_arrays",
           "sa_carry_from_arrays", "sa_carry_to_arrays",
           "encoding_from_fields", "lm_params_from_arrays", "lm_caches_from_arrays",
           "lm_params_block", "lm_params_join", "lm_caches_block", "lm_caches_join",
           "lm_batch_block", "train_state_block", "train_state_join",
           "train_state_from_arrays", "train_state_to_arrays"]

_ENCODINGS = {"qubo": QUBOProblem, "mis": MISProblem, "coloring": ColoringProblem,
              "partition": PartitionProblem}


def ising_from_arrays(
    n: int,
    h: np.ndarray,
    nbr_idx: np.ndarray,
    nbr_w: np.ndarray,
    edges: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    name: str = "ising",
) -> IsingModel:
    """The port's model from another package's (h, nbr_idx, nbr_w) arrays.

    With ``edges``/``weights`` the model is rebuilt by
    :meth:`IsingModel.from_edges`, and a slot order that differs from the
    given arrays raises ValueError.
    """
    model = IsingModel(
        n=int(n),
        h=np.asarray(h, np.int32),
        nbr_idx=np.asarray(nbr_idx, np.int32),
        nbr_w=np.asarray(nbr_w, np.int32),
        name=name,
    )
    if edges is not None:
        rebuilt = IsingModel.from_edges(int(n), edges, weights, h=h, name=name)
        for a in ("h", "nbr_idx", "nbr_w"):
            if not np.array_equal(getattr(rebuilt, a), getattr(model, a)):
                raise ValueError(f"{a} differs from the edge list's slot order")
    return model


def _as_i32(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=True)).to(device)


def packed_j_from_arrays(sign: np.ndarray, mags: np.ndarray, base: np.ndarray,
                         device=None) -> PackedJ:
    """The port's :class:`PackedJ` from another package's coupling planes:
    ``sign`` (..., N, Nw) and ``mags`` (..., n_bits, N, Nw) uint32 words,
    ``base`` (..., N) integers."""
    return PackedJ(_as_i32(sign, device), _as_i32(mags, device), _as_i32(base, device))


def engine_state_from_arrays(
    noise_state: np.ndarray,
    m: np.ndarray,
    itanh: np.ndarray,
    best_H: np.ndarray,
    best_m: np.ndarray,
    *,
    packed: bool = False,
    device=None,
) -> Union[EngineState, PackedEngineState]:
    """Build an engine state from numpy arrays.

    ``noise_state`` is the (4, T, N) uint32 xorshift lanes or a (2,) uint32
    threefry key; ``m``/``best_m`` are (T, N) ±1 spins, or (T, ceil(N/32))
    uint32 words when ``packed``.
    """
    key = np.asarray(noise_state)
    if key.shape == (2,):
        ns = tuple(int(k) for k in key.astype(np.uint32))
    else:
        ns = _as_i32(noise_state, device)
    it = _as_i32(itanh, device)
    bh = _as_i32(best_H, device)
    if packed:
        return PackedEngineState(ns, _as_i32(m, device), it, bh, _as_i32(best_m, device))
    spins = [torch.from_numpy(np.asarray(a, np.int8).copy()).to(device) for a in (m, best_m)]
    return EngineState(ns, spins[0], it, bh, spins[1])


def engine_state_to_arrays(
    state: Union[EngineState, PackedEngineState],
) -> Tuple[np.ndarray, ...]:
    """(noise_state, m, itanh, best_H, best_m) as numpy arrays, with the
    lanes (or the threefry key) and packed words as uint32 and unpacked
    spins as int8."""
    if isinstance(state.noise_state, tuple):
        state = state._replace(noise_state=torch.tensor(
            np.asarray(state.noise_state, np.uint32).view(np.int32)))
    ns, m, it, bh, bm = (t.cpu().numpy() for t in state)
    if isinstance(state, PackedEngineState):
        m, bm = m.view(np.uint32), bm.view(np.uint32)
    return ns.view(np.uint32), m, it, bh, bm


def iteration_state_from_arrays(rng: np.ndarray, m: np.ndarray, itanh: np.ndarray,
                                best_H: np.ndarray, best_m: np.ndarray, *, packed: bool = False,
                                device=None) -> Tuple[torch.Tensor, ...]:
    """The state tuple of the iteration steps
    (:mod:`repro_torch.core.distributed`) from another package's arrays,
    one problem's or a batch's: ``rng`` (4, [B,] T, N) uint32 lanes, ``m``
    float32 ±1 spins, ``itanh`` and ``best_H`` integers, ``best_m`` int8
    spins; with ``packed``, ``m`` and ``best_m`` are (…, T, ceil(N/32))
    uint32 words.  Lanes and words become int32 tensors of the same bits."""
    if packed:
        spins = (_as_i32(m, device), _as_i32(best_m, device))
    else:
        spins = (torch.from_numpy(np.asarray(m, np.float32).copy()).to(device),
                 torch.from_numpy(np.asarray(best_m, np.int8).copy()).to(device))
    return (_as_i32(rng, device), spins[0], _as_i32(itanh, device), _as_i32(best_H, device),
            spins[1])


def iteration_state_to_arrays(state) -> Tuple[np.ndarray, ...]:
    """Inverse of :func:`iteration_state_from_arrays`: the lanes as uint32,
    packed words (int32 spin leaves) as uint32, float32 and int8 spins as
    they are."""
    rng, m, it, bh, bm = (t.cpu().numpy() for t in state)
    if m.dtype == np.int32:
        m = m.view(np.uint32)
    if bm.dtype == np.int32:
        bm = bm.view(np.uint32)
    return rng.view(np.uint32), m, it, bh, bm


def _form_specs(batched: bool, form: dict):
    specs = iteration_specs(batched, **form)
    return [spec for _, spec in specs], [name for name, _ in specs]


def _coords(mesh_shape, rank: int) -> dict:
    """Rank ``rank``'s coordinate on each axis of ``mesh_shape`` (axis →
    size, in the mesh's order; ranks row-major)."""
    from .sharding import mesh_coords

    return dict(zip(mesh_shape, mesh_coords(tuple(mesh_shape.values()), rank)))


def _block_index(entry, mesh_shape, coords: dict) -> Tuple[int, int]:
    """(blocks, this rank's block) along a dim placed on ``entry``: a mesh
    axis, a tuple of them (row-major, the first outermost) or None; an axis
    the mesh lacks counts as one rank."""
    idx, n = 0, 1
    for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
        idx, n = idx * mesh_shape.get(a, 1) + coords.get(a, 0), n * mesh_shape.get(a, 1)
    return n, idx


def _cut(a: torch.Tensor, spec, mesh_shape, coords: dict, pad=0) -> torch.Tensor:
    """A rank's block of ``a`` placed by ``spec``; a dim its blocks do not
    divide is first padded with ``pad`` to blocks × ceil(dim / blocks)."""
    import dataclasses

    from .sharding import block

    sizes = tuple(mesh_shape.values())
    rank = 0
    for axis, size in zip(mesh_shape, sizes):
        rank = rank * size + coords.get(axis, 0)
    return block(dataclasses.replace(_spec_mesh(mesh_shape), rank=rank), a, spec, pad)


def _join(blocks, spec, mesh_shape, shape, name: str) -> torch.Tensor:
    """The whole array of ``shape`` from every rank's block (``blocks[r]``:
    rank r's, placed by ``spec``), inverse of :func:`_cut`: the blocks
    concatenated along the placed dims, the last first, and the padding
    cut off.  Ranks that hold a replica of a block (every rank of an axis
    the array is not placed on) must agree: ValueError otherwise."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    grid = {}
    for rank, blk in enumerate(blocks):
        c = _coords(mesh_shape, rank)
        key = tuple(_block_index(e, mesh_shape, c)[1] for e in spec)
        if key not in grid:
            grid[key] = blk
        elif not torch.equal(grid[key], blk):
            raise ValueError(f"{name}: rank {rank}'s replica of block {key} differs")
    for dim in reversed(range(len(spec))):
        merged = {}
        for key in sorted(grid):
            merged.setdefault(key[:dim], []).append(grid[key])
        grid = {k: v[0] if len(v) == 1 else torch.cat(v, dim=dim) for k, v in merged.items()}
    whole = grid[()]
    for dim, n in enumerate(shape):
        if whole.shape[dim] < n:
            raise ValueError(f"{name}: joined shape {tuple(whole.shape)} < {tuple(shape)}")
        whole = whole.narrow(dim, 0, n)
    return whole.contiguous()


def iteration_state_block(state, problem, mesh, *, rank: Optional[int] = None,
                          batched: bool = False, **form) -> Tuple[tuple, tuple]:
    """(state block, operand block): rank ``rank``'s blocks (the mesh's own
    rank when None) of a whole state tuple and of the step's whole
    operands (``J, h``, or the batched forms' ``*problem, h``), placed as
    :func:`~repro_torch.core.distributed.iteration_specs` says for
    ``batched`` and ``form`` (``storage_layout``, ``j_mode``,
    ``field_mode``).

    A dim its axis does not divide is padded to ranks × ceil(dim / ranks):
    pad spins +1, lanes, itanh, words and operands 0, best_H BIG_ENERGY.
    The dense J is cut as Jᵀ, so a rank holds the coupling rows of its own
    spins — J's own rows for the symmetric J of an Ising model."""
    specs, names = _form_specs(batched, form)
    coords = _coords(mesh.shape, mesh.rank if rank is None else rank)
    blocks = []
    for name, spec, a in zip(names, specs, (*state, *problem)):
        if name == "J":
            a = a.transpose(-1, -2)
        pad = {"m": 1, "best_m": 1, "best_H": BIG_ENERGY}.get(name, 0)
        if a.dtype == torch.int32 and name in ("m", "best_m"):
            pad = 0  # packed words
        blocks.append(_cut(a, spec, mesh.shape, coords, pad))
    k = len(state)
    return tuple(blocks[:k]), tuple(blocks[k:])


def iteration_state_join(blocks, mesh, shapes, *, batched: bool = False, **form) -> tuple:
    """The whole state tuple from every rank's state block (``blocks[r]``:
    rank r's), inverse of :func:`iteration_state_block`: each leaf's blocks
    concatenated along its sharded dims, cut back to ``shapes`` (the whole
    leaves' shapes, or any arrays of those shapes).  Ranks that hold a replica of a
    block (every rank of an axis the leaf is not placed on) must agree:
    ValueError otherwise."""
    specs, names = _form_specs(batched, form)
    return tuple(_join([blk[leaf] for blk in blocks], spec, mesh.shape,
                       tuple(getattr(shapes[leaf], "shape", shapes[leaf])), name)
                 for leaf, (spec, name) in enumerate(zip(specs[:5], names[:5])))


def sa_carry_from_arrays(key: np.ndarray, m: np.ndarray, H: np.ndarray, best_H: np.ndarray,
                         best_m: np.ndarray, *, device=None):
    """An SA carry from numpy arrays: one problem's ``(key, m, H, best_H,
    best_m)`` tuple (key (2,) uint32, spins (T, N)), or a batched
    :class:`~repro_torch.core.sa.SACarry` when the key is (B, 2)."""
    key = np.asarray(key).astype(np.uint32).astype(np.int64)
    leaves = [torch.from_numpy(np.asarray(a, np.int32).copy()).to(device)
              for a in (m, H, best_H, best_m)]
    if key.shape == (2,):
        return (tuple(int(k) for k in key), *leaves)
    return SACarry(key.reshape(-1, 2), *leaves)


def sa_carry_to_arrays(carry) -> Tuple[np.ndarray, ...]:
    """(key uint32, m, H, best_H, best_m int32) of an SA carry, either form."""
    key, *leaves = carry
    return (np.asarray(key, np.int64).astype(np.uint32),
            *(t.cpu().numpy() for t in leaves))


def encoding_from_fields(model: dict, **fields):
    """The port's encoding from another package's fields: ``model`` holds
    the Ising arrays (``n``, ``h``, ``nbr_idx``, ``nbr_w``, ``name``),
    ``fields`` the encoding's other dataclass fields (``kind``, which picks
    the family, ``offset``, ``minimize`` and the instance data: ``Q``,
    ``edges``, ``values``, …) as numpy arrays or scalars."""
    cls = _ENCODINGS[fields["kind"]]
    fields = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in fields.items()}
    return cls(model=ising_from_arrays(**model), **fields)


def _lm_leaf(a, device) -> torch.Tensor:
    """One array of an LM tree as a tensor of its dtype; a bfloat16 array
    (numpy has no bfloat16: ``ml_dtypes``' type, named 'bfloat16') goes
    through float32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _lm_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _lm_tree(v, device) for k, v in tree.items()}
    return _lm_leaf(tree, device)


def lm_params_from_arrays(tree, device=None):
    """The port's LM parameters (``repro_torch.models``) from another
    package's: a nested dict of numpy arrays with the reference's paths
    (``{"embed": {"tok": …}, "decoder": {"l0": {"mixer": {"wq": …}}}}``),
    each leaf a tensor of its dtype on ``device``."""
    return _lm_tree(tree, device)


def lm_caches_from_arrays(tree, device=None):
    """The port's prefill/decode caches from another package's nested dict
    of numpy arrays (``{"decoder": {"l0": {"mixer": {"k": …}}}}``):
    bfloat16 K/V, conv and shift leaves stay bfloat16, the float32 states
    float32."""
    return _lm_tree(tree, device)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def train_state_from_arrays(params, step, mu, nu, device=None):
    """The port's :class:`~repro_torch.train.step.TrainState` from another
    package's: the parameter tree, ``OptState.step`` (an integer) and the
    ``mu``/``nu`` moment trees as numpy arrays, on ``device``."""
    from .optim.adamw import OptState
    from .train.step import TrainState

    opt = OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                   mu=_lm_tree(mu, device), nu=_lm_tree(nu, device))
    return TrainState(params=_lm_tree(params, device), opt=opt)


def train_state_to_arrays(state):
    """(params, step, mu, nu) of a port TrainState as numpy: the trees of
    arrays and the step as an int32 scalar, the reference's
    ``TrainState(params, OptState(step, mu, nu))`` leaves."""
    return (_np_tree(state.params), np.int32(int(state.opt.step)),
            _np_tree(state.opt.mu), _np_tree(state.opt.nu))


# ---------------------------------------------------------------------------
# The LM's blocks on a mesh
# ---------------------------------------------------------------------------
def _spec_mesh(mesh_shape):
    from .sharding import abstract_mesh

    return abstract_mesh(tuple(mesh_shape.values()), tuple(mesh_shape))


def lm_params_block(params, cfg, mesh_shape, coords):
    """A rank's blocks of the LM parameters (whole trees with the
    reference's paths): each leaf cut as ``models.params.param_pspecs``
    places it.  ``mesh_shape`` maps each mesh axis to its size, in the
    mesh's order (``mesh.shape``); ``coords`` are the rank's coordinates
    (``mesh.coords``).  The placements are DEFAULT_RULES', the only
    rules a mesh runs."""
    from .models import model_defs
    from .models.params import tree_map
    from .sharding import logical_to_spec

    m, c = _spec_mesh(mesh_shape), dict(zip(mesh_shape, coords))
    return tree_map(lambda a, d: _cut(a, logical_to_spec(m, d.shape, d.axes),
                                      mesh_shape, c), params, model_defs(cfg))


def lm_params_join(blocks, cfg, mesh_shape):
    """The whole parameters from every rank's blocks (``blocks[r]``: rank
    r's, r row-major over ``mesh_shape``); replicas must agree."""
    from .models import model_defs

    return _join_tree(blocks, model_defs(cfg), mesh_shape)


def _join_tree(blocks, defs, mesh_shape):
    """Each leaf of ``defs`` (ParamDefs: the whole shapes and logical axes)
    joined from the blocks at its path."""
    from .models.params import tree_paths
    from .sharding import logical_to_spec

    m = _spec_mesh(mesh_shape)
    out: dict = {}
    for path, d in tree_paths(defs):
        leaves = []
        for b in blocks:
            for k in path:
                b = b[k]
            leaves.append(b)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _join(leaves, logical_to_spec(m, d.shape, d.axes), mesh_shape,
                               d.shape, "/".join(path))
    return out


def _cache_axes(cfg):
    from .models import cache_defs

    return cache_defs(cfg, 1, 1)


def lm_caches_block(caches, cfg, mesh_shape, coords):
    """A rank's blocks of whole prefill/decode caches (``{"decoder": …}``),
    placed as the JAX package's ``decode_lowering`` places them: K/V by
    ("batch", "kv_seq", "kv_heads", "d_head") under the layer stack."""
    from .models.params import tree_map
    from .sharding import logical_to_spec

    m, c = _spec_mesh(mesh_shape), dict(zip(mesh_shape, coords))
    return tree_map(lambda a, d: _cut(a, logical_to_spec(m, a.shape, d.axes),
                                      mesh_shape, c), caches, _cache_axes(cfg))


def lm_caches_join(blocks, cfg, batch: int, max_seq: int, mesh_shape):
    """The whole caches of ``batch`` rows and ``max_seq`` positions from
    every rank's blocks; replicas must agree."""
    from .models import cache_defs

    return _join_tree(blocks, cache_defs(cfg, batch, max_seq), mesh_shape)


def lm_batch_block(batch, mesh_shape, coords):
    """A rank's rows of the model inputs (tokens, patches, frames, a decode
    step's tokens): each placed by ("batch", None, …), as the JAX
    package's ``batch_shardings``."""
    from .sharding import logical_to_spec

    m, c = _spec_mesh(mesh_shape), dict(zip(mesh_shape, coords))
    return {k: _cut(v, logical_to_spec(m, v.shape, ("batch",) + (None,) * (v.dim() - 1)),
                    mesh_shape, c) for k, v in batch.items()}


def _state_shardings(cfg, mesh_shape):
    from .train.step import TrainConfig, train_state_shardings

    return train_state_shardings(cfg, TrainConfig(), _spec_mesh(mesh_shape))


def train_state_block(state, cfg, mesh_shape, coords):
    """A rank's blocks of a whole TrainState: the parameters as
    :func:`lm_params_block` cuts them, ``step`` whole, the moments by
    their ZeRO-1 placement (``optim.adamw.zero1_spec``: the parameter's
    spec plus ``data``)."""
    from .models.params import tree_map
    from .optim.adamw import OptState
    from .train.step import TrainState

    sh = _state_shardings(cfg, mesh_shape)
    c = dict(zip(mesh_shape, coords))

    def cut(tree, shardings):
        return tree_map(lambda a, ns: _cut(a, ns.spec, mesh_shape, c), tree, shardings)

    return TrainState(params=cut(state.params, sh.params),
                      opt=OptState(step=state.opt.step.clone(), mu=cut(state.opt.mu, sh.opt.mu),
                                   nu=cut(state.opt.nu, sh.opt.nu)))


def train_state_join(blocks, cfg, mesh_shape):
    """The whole TrainState from every rank's blocks (``blocks[r]``: rank
    r's, r row-major over ``mesh_shape``), inverse of
    :func:`train_state_block`; replicas (``step`` included) must agree."""
    from .models import model_defs
    from .models.params import tree_paths
    from .optim.adamw import OptState
    from .train.step import TrainState

    sh = _state_shardings(cfg, mesh_shape)
    defs = dict(tree_paths(model_defs(cfg)))

    def join(field):
        out: dict = {}
        for path, ns in tree_paths(getattr(sh.opt, field) if field != "params" else sh.params):
            leaves = []
            for b in blocks:
                t = b.params if field == "params" else getattr(b.opt, field)
                for k in path:
                    t = t[k]
                leaves.append(t)
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _join(leaves, ns.spec, mesh_shape, defs[path].shape,
                                   "/".join((field,) + path))
        return out

    step = _join([b.opt.step for b in blocks], (), mesh_shape, (), "opt/step")
    return TrainState(params=join("params"),
                      opt=OptState(step=step, mu=join("mu"), nu=join("nu")))
