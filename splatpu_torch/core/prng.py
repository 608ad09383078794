"""The JAX package's random draws: threefry2x32 keys, ``split``,
``random_bits``, ``uniform`` and ``normal`` as ``jax.random`` computes them
with ``jax_threefry_partitionable`` on (its default) and 64-bit types off
(the JAX package's setting), and nothing more.

A key is a (2,) uint32 numpy array, the raw key data of ``jax.random.key``
(and the form of the stage-1 checkpoint's ``key`` field).  ``split`` runs on
the host and returns keys; the draws run on the device the caller names,
as int64 tensors masked to 32 bits (torch's uint32 lacks the operators).

- Keys, ``split`` and ``random_bits`` are exact integer arithmetic, equal
  to JAX's bit for bit.
- ``uniform`` builds floats in [1, 2) from the top 23 bits, subtracts 1,
  and computes ``floats * (maxval - minval) + minval`` with one rounding,
  as XLA's fused multiply-add does on a CPU; ``maxval - minval`` is
  rounded to float32 first.
- ``normal`` is ``sqrt(2) * erf_inv(u)`` for ``u`` uniform in (-1, 1).
  ``erf_inv`` is the port's copy of what XLA compiles for a CPU: Giles'
  float32 polynomial over Cephes' ``log1p``, each multiply-add that the
  compiled code fuses rounded once.  ``torch.erfinv`` is another
  approximation, and torch's float32 ``sqrt`` on a CPU is not correctly
  rounded, so neither is used.

Each step is one IEEE operation in float32, or one in float64 rounded to
float32: a square root, a quotient, or a multiply-add whose product
float64 holds exactly (its sum could round twice only where float64's
rounding lands on a float32 midpoint; no draw the tests hold against
JAX's meets one).  So a CPU and a CUDA device compute the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

def _f32(*values) -> tuple[float, ...]:
    return tuple(float(np.float32(v)) for v in values)


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"):
# Horner coefficients, highest power first, for w < 5 and for w >= 5.
_ERFINV_LT5 = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = _f32(-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                   0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's float32 log1p on a CPU: Cephes' logf polynomial in three Horner
# pieces and its exponent split (q1 + q2 = log 2), and Cephes' log1p
# rational (numerator and denominator, highest power first; the
# denominator's leading 1 is implied).
_LOG_P = (_f32(0.070376836, -0.1151461, 0.116769984),
          _f32(-0.12420141, 0.14249323, -0.16668057),
          _f32(0.20000714, -0.24999994, 0.3333333))
_LOG_Q1, _LOG_Q2 = _f32(-0.00021219444, 0.693359375)
_LOG1P_NUM = _f32(4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967, 57.112965, 20.039553)
_LOG1P_DEN = _f32(15.062909, 83.04757, 221.7624, 309.09872, 216.42789, 60.11866)
_LOG1P_SMALL, _SQRT_HALF, _FLT_MIN, _SQRT2 = _f32(0.41421357, 0.70710677, 1.1754944e-38,
                                                  math.sqrt(2))


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data, (high, low) words.  With 64-bit
    types off JAX casts the seed to int32 first, so the high word is 0 and
    the low word is the seed's low 32 bits, for any seed."""
    return np.array([0, int(seed) & _MASK], np.uint32)


PRNGKey = key


def _words(k) -> tuple[int, int]:
    k = np.asarray(k, np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    (int64 tensors holding uint32 values) under key words ``k``."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _hash_iota(k, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the row-major flat index over ``shape`` as (high,
    low) words (JAX's ``iota_2x32_shape``)."""
    flat = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(_words(k), flat >> 32, flat & _MASK)
    return b0.reshape(shape), b1.reshape(shape)


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``'s data: (num, 2) uint32 keys, hashed on
    the host."""
    b0, b1 = _hash_iota(k, (num,), "cpu")
    return torch.stack([b0, b1], dim=-1).numpy().astype(np.uint32)


def random_bits(k, shape, device="cuda") -> torch.Tensor:
    """32 random bits per entry of ``shape`` (int64 tensor on ``device``)."""
    b0, b1 = _hash_iota(k, tuple(shape), device)
    return b0 ^ b1


def uniform(k, shape, minval=0.0, maxval=1.0, device="cuda") -> torch.Tensor:
    """Float32 uniform in [minval, maxval) over ``shape`` on ``device``."""
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    bits = (random_bits(k, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    out = (floats.double() * float(span) + float(lo)).float()
    return torch.clamp(out, min=float(lo))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` as an FMA instruction computes it in float32: the
    product is exact in float64, the sum is rounded to float32."""
    return (a.double() * b + c).float()


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` on a CPU, for x in (-1, 0]: Cephes' rational
    for |x| < sqrt(2) - 1, else Cephes' ``logf`` of 1 + x; the
    multiply-adds fused where XLA's compiled code fuses them."""
    y = x + 1.0
    bits = torch.clamp(y, min=_FLT_MIN).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    ef = ((bits >> 23) - 127).float() + 1.0
    lt = m < _SQRT_HALF
    t = (m - 1.0) + torch.where(lt, m, 0.0)
    ef = torch.where(lt, ef - 1.0, ef)
    t2 = t * t
    t3 = t2 * t
    a, b, c = (_fma(_fma(t, k0, k1), t, k2) for k0, k1, k2 in _LOG_P)
    r = _fma(t3, _fma(t3, _fma(t3, a, b), c), ef * _LOG_Q1)
    large = _fma(ef, _LOG_Q2, (t - 0.5 * t2) + r)
    num = torch.full_like(x, _LOG1P_NUM[0])
    den = torch.ones_like(x)
    for n_i, d_i in zip(_LOG1P_NUM[1:], _LOG1P_DEN):
        num = _fma(x, num, n_i)
        den = _fma(x, den, d_i)
    x2 = x * x
    small = x + ((x * x2) * (num.double() / den).float() - 0.5 * x2)
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on a float32 tensor in (-1, 1)."""
    lw = _log1p(x * -x)  # -w
    lt = lw > -5.0
    # torch's float32 sqrt on a CPU is not correctly rounded; float64's,
    # rounded to float32, is.
    t = torch.where(lt, -2.5 - lw, torch.sqrt(-lw.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(t, p, torch.where(lt, c_lt, c_ge))
    return x * torch.where(x.abs() == 1.0, math.inf, p)


def normal(k, shape, device="cuda") -> torch.Tensor:
    """Float32 standard normal over ``shape`` on ``device``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0, device)
    return erf_inv(u) * _SQRT2
