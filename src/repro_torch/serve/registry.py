"""Algorithm-family registry of the annealing service (port of
``repro.serve.registry``).

Each family registers:

* ``name`` — the wire name (``AnnealRequest(algo=...)``, group keys,
  progress reports);
* ``hp_type`` — the hyper-parameter dataclass that implies the family when
  ``algo`` is not given, most specific type first:
  :class:`~repro_torch.core.ssqa.SSQAHyperParams` subclasses
  :class:`~repro_torch.core.ssa.SSAHyperParams`, so an SSQA hp lands on
  ``ssqa``;
* ``solver`` — the name of the ``AnnealService`` group-solver method;
* ``group_key`` — the family's part of the batching key (what must match
  for two requests to share one program);
* ``validate`` — admission rules that live next to the family (SSQA on the
  cuda backend needs streamed xorshift noise).

The port registers ``ssa`` and ``ssqa``.  ``algo='sa'`` and
``algo='ptssa'`` raise NotImplementedError naming ROADMAP.md queue 1 step 5.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ..core.config import not_ported
from ..core.ssa import SSAHyperParams
from ..core.ssqa import SSQAHyperParams
from .resilience import AdmissionError

__all__ = ["AlgoFamily", "register_algo", "registered_algos", "family_for"]

# Families of the JAX package that wait for their cores to be ported.
_NOT_PORTED = ("sa", "ptssa")


@dataclasses.dataclass(frozen=True)
class AlgoFamily:
    """One served algorithm family (see the module docstring)."""

    name: str
    hp_type: type
    solver: str                    # AnnealService method name (bound late)
    group_key: Callable            # (req, hp, nb) -> hashable batching key
    validate: Optional[Callable] = None  # (service, idx, req, hp) -> None
    chunk_unit: str = "m_shot"     # hp attribute the chunk width divides


_REGISTRY: Dict[str, AlgoFamily] = {}


def register_algo(name: str, hp_type: type, *, solver: str, group_key: Callable,
                  validate: Optional[Callable] = None,
                  chunk_unit: str = "m_shot") -> AlgoFamily:
    """Register (or replace) an algorithm family under ``name``."""
    fam = AlgoFamily(str(name), hp_type, solver, group_key, validate, chunk_unit)
    _REGISTRY[fam.name] = fam
    return fam


def registered_algos() -> Dict[str, AlgoFamily]:
    return dict(_REGISTRY)


def _family_for_type(hp) -> AlgoFamily:
    """The most specific registered family whose hp_type matches ``hp``."""
    best: Optional[AlgoFamily] = None
    for fam in _REGISTRY.values():
        if isinstance(hp, fam.hp_type):
            if best is None or issubclass(fam.hp_type, best.hp_type):
                best = fam
    if best is None:
        raise TypeError(f"unsupported hyperparameter type {type(hp).__name__}; "
                        f"registered families: {sorted(_REGISTRY)}")
    return best


def family_for(hp, algo: Optional[str] = None) -> AlgoFamily:
    """The family of a request: its explicit ``algo``, which must agree with
    what the hp type implies, or the hp type's."""
    if algo in _NOT_PORTED:
        raise not_ported(f"algo={algo!r}", "sa_pt")
    tfam = _family_for_type(hp)
    if algo is None:
        return tfam
    fam = _REGISTRY.get(algo)
    if fam is None:
        raise AdmissionError(f"unknown algo {algo!r}; registered: {sorted(_REGISTRY)}")
    if fam is not tfam:
        raise AdmissionError(f"algo={algo!r} does not match hyperparameter type "
                             f"{type(hp).__name__} (which selects family {tfam.name!r})")
    return fam


# ----------------------------------------------------------------------
# Built-in families
# ----------------------------------------------------------------------
def _plateau_group_key(name):
    def key(req, hp, nb):
        sig = hp.schedule(req.schedule_kind).signature()
        return (name, nb, hp.n_trials, hp.n_rnd, hp.m_shot, req.storage, sig)
    return key


def _validate_ssqa(service, idx, req, hp):
    # The batched cuda SSQA path is the streamed-noise ring modes (K4 has
    # none): reject at admission instead of faulting mid-batch.
    if service.backend == "cuda":
        if service.noise != "xorshift":
            raise AdmissionError(
                f"request {idx}: ssqa on backend='cuda' requires noise='xorshift' "
                f"(the streamed-noise ring modes), got noise={service.noise!r}")
        if service.backend_opts.get("noise_mode") == "pregen":
            raise AdmissionError(
                f"request {idx}: ssqa on backend='cuda' requires noise_mode='streamed'; "
                "drop noise_mode='pregen' from backend_opts")


register_algo("ssa", SSAHyperParams, solver="_solve_ssa_group",
              group_key=_plateau_group_key("ssa"))
register_algo("ssqa", SSQAHyperParams, solver="_solve_ssa_group",  # the SSA plateau path
              group_key=_plateau_group_key("ssqa"), validate=_validate_ssqa)
