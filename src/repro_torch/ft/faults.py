"""Fault injection for the annealing service (port of ``repro.ft.faults``).

The service's resilience layer is only trustworthy if every failure path is
exercised on purpose; this module is the harness that does it.
:class:`FaultInjector` is a registry of *armed* faults that the service
fires at its hook points: each hook either raises a typed injected error
(build failure, out of memory, process kill) or returns a corruption spec
that the caller applies to its own readings (a NaN burst).  The injector is
plain host-side Python, so faults land at the boundaries where real faults
land — program build, problem stacking, chunk boundaries — and the recovery
code under test is the production code.

Hook points (fired by :class:`repro_torch.serve.AnnealService`):

=========  ==================================================  =============
point      fires at                                            effect
=========  ==================================================  =============
'compile'  program-cache miss, before the backend is built     raises
           (ctx: backend, kind, bucket)                        InjectedCompileFailure
'oom'      after stacking the problem arrays (ctx: backend,    raises
           j_mode, bucket, batch)                              InjectedOOM
'nan'      each chunk boundary, on the energy readings         returns the spec;
           (ctx: kind, chunk)                                  caller plants NaN
                                                               in ``spec.slots``
'kill'     each chunk boundary (ctx: kind, chunk)              raises
                                                               InjectedKill
=========  ==================================================  =============

:func:`chaos_schedule` builds a seeded, finite fault plan over those points.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

__all__ = [
    "SimulatedFailure",
    "InjectedFault",
    "InjectedCompileFailure",
    "InjectedOOM",
    "InjectedKill",
    "FaultSpec",
    "FaultInjector",
    "FAULT_POINTS",
    "chaos_schedule",
]

FAULT_POINTS = ("compile", "oom", "nan", "kill")


class SimulatedFailure(RuntimeError):
    """An emulated loss of the process (the base of :class:`InjectedKill`)."""


class InjectedFault(RuntimeError):
    """Base class of injector-raised faults (never raised by real code)."""


class InjectedCompileFailure(InjectedFault):
    """Emulates a kernel build or launch failure."""


class InjectedOOM(InjectedFault):
    """Emulates a device allocation failure (out of memory)."""


class InjectedKill(InjectedFault, SimulatedFailure):
    """Emulates the process dying mid-solve (must escape all handlers)."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: a hook point, a shot budget and context filters.

    ``match`` keys are compared with the hook's keyword context; a spec
    fires only when every match key is present and equal.  ``slots`` names
    the batch slots a 'nan' burst corrupts (empty = every slot).
    """

    point: str
    count: int = 1
    match: Dict[str, object] = dataclasses.field(default_factory=dict)
    slots: Tuple[int, ...] = ()

    def matches(self, ctx: Dict[str, object]) -> bool:
        return self.count > 0 and all(ctx.get(k) == v for k, v in self.match.items())


class FaultInjector:
    """Armed-fault registry and fired-fault log.

    ``arm()`` registers a fault; ``fire()`` is called by the service at each
    hook point and consumes the first matching armed spec.  Raising points
    ('compile', 'oom', 'kill') raise their typed error; the passive point
    ('nan') returns the spec for the caller to apply.  Every firing is
    appended to ``log``.
    """

    def __init__(self, specs: Optional[List[FaultSpec]] = None):
        self.specs: List[FaultSpec] = list(specs or [])
        self.log: List[Tuple[str, Dict[str, object]]] = []

    def arm(self, point: str, *, count: int = 1, slots: Tuple[int, ...] = (),
            **match) -> FaultSpec:
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; known: {FAULT_POINTS}")
        spec = FaultSpec(point=point, count=int(count), match=dict(match), slots=tuple(slots))
        self.specs.append(spec)
        return spec

    def fire(self, point: str, **ctx) -> Optional[FaultSpec]:
        for spec in self.specs:
            if spec.point != point or not spec.matches(ctx):
                continue
            spec.count -= 1
            self.log.append((point, dict(ctx)))
            detail = ", ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
            if point == "compile":
                raise InjectedCompileFailure(f"injected compile failure ({detail})")
            if point == "oom":
                raise InjectedOOM(f"injected out of memory ({detail})")
            if point == "kill":
                raise InjectedKill(f"injected process kill ({detail})")
            return spec  # 'nan': the caller plants the corruption
        return None

    @property
    def exhausted(self) -> bool:
        return all(s.count <= 0 for s in self.specs)


def chaos_schedule(
    seed: int,
    *,
    n_faults: int = 3,
    points: Tuple[str, ...] = FAULT_POINTS,
    fallback_backends: Tuple[str, ...] = ("cuda", "dense"),
    max_chunk: int = 4,
    n_slots: int = 2,
) -> FaultInjector:
    """A seeded, finite fault plan: ``n_faults`` armed specs drawn from
    ``points``.  Deterministic for a fixed seed.  Compile and OOM faults
    are matched to ``fallback_backends`` only (a fault on the chain's last
    backend tests surfacing, not recovery); kill and NaN faults land at a
    random chunk boundary below ``max_chunk``."""
    rng = random.Random(seed)
    inj = FaultInjector()
    for _ in range(int(n_faults)):
        point = rng.choice(list(points))
        if point in ("compile", "oom"):
            inj.arm(point, backend=rng.choice(list(fallback_backends)))
        elif point == "kill":
            inj.arm(point, chunk=rng.randrange(max_chunk))
        else:  # nan
            inj.arm(point, chunk=rng.randrange(max_chunk),
                    slots=(rng.randrange(max(1, n_slots)),))
    return inj
