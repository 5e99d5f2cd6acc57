"""Typed solver configuration (port of ``repro.core.config``).

:class:`SolverConfig` holds the execution options of the plateau engine in
one frozen, validated object.  This port honours the options of the
single-problem annealer on one GPU; every option that the JAX package has
but this port does not yet run raises :class:`NotImplementedError` naming
the ROADMAP.md item it waits for — on the CPU as on the card, with no
substitute path.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple

__all__ = ["SolverConfig", "not_ported"]

_BACKENDS = ("sparse", "dense", "cuda")
_LAYOUTS = ("dense", "packed")

# What each option outside the ported slice waits for, by ROADMAP.md item.
_WAITS = {
    "j_opts": "ROADMAP.md queue 1 step 2 (DenseBackend's j_dtype and double_buffer)",
    "spin": "ROADMAP.md queue 1 step 8 (spin sharding across GPUs)",
    "auto_backend": "ROADMAP.md queue 1 step 3 (MIN_RESIDENT_N re-derived on "
                    "the H100 before backend='auto' can choose)",
}


def not_ported(option: str, item: str) -> NotImplementedError:
    """The error raised for an option outside the ported slice."""
    return NotImplementedError(
        f"{option} is not ported to repro_torch yet; it waits for {_WAITS[item]}"
    )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Execution options of the plateau engine, in one object.

    * ``backend`` — 'sparse' | 'dense' | 'cuda' (the resident CUDA kernels;
      the counterpart of the JAX package's 'pallas').
    * ``storage_layout`` — 'dense' | 'packed' inter-plateau spin state.
    * ``field_mode`` — 'auto' (the backend's default, a dense contraction:
      'auto' is not forwarded, as in the JAX package) | 'dense' |
      'popcount' (XNOR-popcount on the coupling bitplanes; on 'cuda' the
      plateau-chain kernel K2, which needs streamed xorshift noise).
    * ``j_mode`` — 'auto' | 'dense' | 'tiled' (dense backend only): 'tiled'
      streams (tile_n, N) J slabs and never holds (N, N); 'auto' tiles above
      ``engine.TILED_J_THRESHOLD`` spins.
    * ``noise`` — 'xorshift' | 'threefry' (``jax.random``'s generator).
    * ``noise_mode`` — 'auto' | 'streamed' | 'pregen' (cuda only):
      'streamed' makes xorshift noise inside the plateau kernel, 'pregen'
      draws a (C, T, N) noise buffer per plateau for the pregenerated-noise
      kernel; 'auto' streams xorshift and pregenerates threefry.
    * ``partition`` — 'problem'.
    * ``backend_opts`` — residual per-backend options as a key-sorted
      tuple of (key, value) pairs.
    """

    backend: str = "sparse"
    storage_layout: str = "dense"
    field_mode: str = "auto"
    j_mode: str = "auto"
    noise: str = "xorshift"
    noise_mode: str = "auto"
    partition: str = "problem"
    backend_opts: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        opts = dict(self.backend_opts) if self.backend_opts else {}
        object.__setattr__(
            self, "backend_opts", tuple(sorted(opts.items(), key=lambda kv: kv[0]))
        )
        if self.backend == "auto":
            raise not_ported("backend='auto'", "auto_backend")
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {_BACKENDS}")
        if self.storage_layout not in _LAYOUTS:
            raise ValueError(
                f"storage_layout {self.storage_layout!r} not in {_LAYOUTS}"
            )
        _check_choice("field_mode", self.field_mode, ("auto", "dense", "popcount"))
        _check_choice("j_mode", self.j_mode, ("auto", "dense", "tiled"))
        _check_choice("noise", self.noise, ("xorshift", "threefry"))
        _check_choice("noise_mode", self.noise_mode, ("auto", "streamed", "pregen"))
        if self.noise_mode == "streamed" and self.noise != "xorshift":
            raise ValueError(
                "noise_mode='streamed' requires the xorshift noise family "
                "(threefry cannot be generated in-kernel)"
            )
        _check_choice("partition", self.partition, ("problem",),
                      {"spin": "spin", "auto": "spin"})

    def opts_dict(self) -> Dict[str, Any]:
        """backend_opts as a live dict (values as passed at construction)."""
        return dict(self.backend_opts)

    def engine_opts(self) -> Dict[str, Any]:
        """kwargs for ``make_backend(**...)`` minus backend/noise.

        Per-backend knobs are emitted only where the configured backend's
        constructor takes them (sparse takes no field or J option).
        """
        out: Dict[str, Any] = {"storage_layout": self.storage_layout}
        bk = self.backend
        if self.field_mode != "auto" and bk != "sparse":
            out["field_mode"] = self.field_mode
        if self.j_mode != "auto" and bk == "dense":
            out["j_mode"] = self.j_mode
        if self.noise_mode != "auto" and bk == "cuda":
            out["noise_mode"] = self.noise_mode
        out.update(self.backend_opts)
        return out

    def signature(self) -> str:
        """Stable 16-hex digest over every behaviour-affecting field: the
        JAX package's payload, with the mesh fingerprint always empty (no
        mesh until spin sharding is ported), so equal options give the JAX
        package's digest.  The service's program-cache keys consume it."""
        payload = (
            "SolverConfig/v1",
            self.backend,
            self.storage_layout,
            self.field_mode,
            self.j_mode,
            self.noise,
            self.noise_mode,
            self.partition,
            (),
            tuple((k, repr(v)) for k, v in self.backend_opts),
        )
        return hashlib.sha256(repr(payload).encode()).hexdigest()[:16]

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


def _check_choice(name: str, value, allowed, waiting: Optional[dict] = None):
    if waiting and value in waiting:
        raise not_ported(f"{name}={value!r}", waiting[value])
    if value not in allowed:
        raise ValueError(f"{name} {value!r} not in {allowed}")
