"""``jnp.log``, ``jnp.log1p`` and ``lax.erf_inv`` of float32 as XLA computes
them on the CPU, bit for bit.

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

``jax.random.normal`` draws ``√2 · erf_inv(u)`` of a uniform ``u`` on
(−1, 1).  ``erf_inv`` is lowered (CHLO) to Giles' two degree-8
polynomials in ``w = −log1p(−u²)``, and XLA's CPU emitter computes
``log1p`` as Cephes' rational function below √2 − 1 and as ``log(1 + x)``
above it; the compiled code fuses each Horner step and one add of the
rational branch into a multiply-add.  :func:`xla_log1p` and
:func:`xla_erf_inv` take the same steps, checked over all 2^23 values of
the uniform draw in the tests.
"""
from __future__ import annotations

import torch

__all__ = ["xla_log", "xla_log1p", "xla_erf_inv", "xla_sqrt"]

_F32, _F64 = torch.float32, torch.float64


def _fma(a, b, c):
    """float32 ``a·b + c`` with one rounding from float64."""
    return (torch.as_tensor(a, dtype=_F64) * torch.as_tensor(b, dtype=_F64)
            + torch.as_tensor(c, dtype=_F64)).to(_F32)


def xla_sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once, as XLA's (IEEE) ``sqrt``: through
    float64, since torch's float32 ``sqrt`` on the CPU is not correctly
    rounded."""
    return torch.sqrt(x.to(_F64)).to(_F32)


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


# Cephes' log1p rational function on |x| < √2 − 1, in XLA's coefficient
# order (highest degree first), and its threshold.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = 0.41421356237309504880


def _horner(x, coeffs):
    r = torch.full_like(x, float(_c(coeffs[0])))
    for c in coeffs[1:]:
        r = _fma(r, x, _c(c).to(x.device))
    return r


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of a float32 tensor in (−1, ∞), equal bit for bit to
    XLA's CPU result (checked over ``−u²`` of every uniform draw of
    ``jax.random.normal``)."""
    x = x.to(_F32)
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = (x * x2) * small
    small = x + _fma(_c(-0.5).to(x.device), x2, small)
    large = xla_log(x + 1.0)
    return torch.where(torch.abs(x) < _c(_LOG1P_SMALL).to(x.device), small, large)


# Giles' erfinv polynomials (w < 5 and w >= 5), highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of a float32 tensor in (−1, 1), equal bit for bit to
    XLA's CPU result (checked over every uniform draw of
    ``jax.random.normal``); ±1 give ±inf."""
    x = x.to(_F32)
    dev = x.device
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, xla_sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, _c(_ERFINV_LT5[i]).to(dev), _c(_ERFINV_GE5[i]).to(dev))

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)
