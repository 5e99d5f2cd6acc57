"""``jnp.log`` of float32 as XLA computes it on the CPU, bit for bit.

SA, PT and PT-SSA accept a Metropolis move on ``log(u) · T < -ΔH`` (and
the swap on ``log(u) < Δβ · ΔE``), with ``u`` a float32 uniform draw.  A
move whose two sides lie within an ulp of each other flips with the last
bit of the logarithm, so a port that is bit-identical to the JAX package
must compute the logarithm exactly as XLA does.  ``torch.log`` does not:
it differs from ``jnp.log`` on many of the 2^23 values that
``uniform(minval=1e-12)`` can take.

XLA's CPU backend lowers ``log`` to Eigen's Cephes-style float32
polynomial with fused multiply-adds.  :func:`xla_log` evaluates the same
steps in torch: every ``fma(a, b, c)`` is ``a·b + c`` in float64 (the
product of two float32 values is exact there) rounded once to float32, and
every other step is a float32 operation.  float64 adds and multiplies are
IEEE on the CPU and on the GPU, so the result is the same on both.  The
domain is positive finite float32 (the uniform draws); subnormal inputs
are taken as the smallest normal float, as Eigen does.
"""
from __future__ import annotations

import torch

__all__ = ["xla_log"]

_F32, _F64 = torch.float32, torch.float64


def _fma(a, b, c):
    """float32 ``a·b + c`` with one rounding from float64."""
    return (torch.as_tensor(a, dtype=_F64) * torch.as_tensor(b, dtype=_F64)
            + torch.as_tensor(c, dtype=_F64)).to(_F32)


def _c(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32)


def xla_log(u: torch.Tensor) -> torch.Tensor:
    """Natural logarithm of a positive float32 tensor, equal bit for bit to
    ``jnp.log`` on the CPU (checked over every value of
    ``jax.random.uniform(minval=1e-12)`` in the tests)."""
    u = torch.clamp(u.to(_F32), min=torch.finfo(_F32).tiny)
    bits = u.view(torch.int32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(_F32)       # mantissa in [0.5, 1)
    e = ((bits >> 23) - 127).to(_F32) + 1.0                 # its exponent
    small = m < _c(0.70710677)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(_F32)
    x2 = x * x
    x3 = x2 * x
    y = _fma(_c(7.0376836292e-2), x, _c(-1.1514610310e-1))
    y1 = _fma(_c(-1.2420140846e-1), x, _c(1.4249322787e-1))
    y2 = _fma(_c(2.0000714765e-1), x, _c(-2.4999993993e-1))
    y = _fma(y, x, _c(1.1676998740e-1))
    y1 = _fma(y1, x, _c(-1.6668057665e-1))
    y2 = _fma(y2, x, _c(3.3333331174e-1))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _c(-2.12194440e-4))
    x = _fma(_c(-0.5), x2, x)
    x = x + y
    return _fma(e, _c(0.693359375), x)
