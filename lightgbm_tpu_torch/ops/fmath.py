"""f32 transcendental functions that round the same way on every device.

``exp_f32`` reproduces XLA:CPU's f32 ``exp`` lowering, which the JAX
package's binary objective runs (``jnp.exp``): the Cephes form of
``xla/service/cpu/polynomial_approximations.cc`` ``GenerateVF32Exp``.

* clamp x to [-87.8, 88.8];
* n = floor(x * log2(e) + 0.5), clamped to [-127, 127];
* a = x - n * C1 - n * C2, with ln 2 = C1 + C2 split for an exact first
  product;
* z = 1 + (a + a^2 * P(a)), P of degree 5 in Horner form;
* e^x = z * 2^n, with 2^-127 built as 0, and a result below 2^-126
  flushed to 0 as XLA's CPU runtime flushes denormals.

Every multiply-add of the reduction and the polynomial is one FUSED
multiply-add, as LLVM emits them for XLA.  PyTorch has no f32 fma, so
:func:`_fma` evaluates ``a * b + c`` in float64 and rounds once to f32: the
product of two f32 values is exact in float64, so only the final add can
round twice, which differs from a true fma only when the float64 sum lands
exactly on an f32 rounding midpoint.  Each step is an elementwise IEEE op
that PyTorch's CPU and CUDA kernels round identically, so the card, the
CPU and the JAX package compute the same bits (``tests/test_torch_kernels
.py`` sweeps the sigmoid's input range against ``jax.jit(jnp.exp)``).
"""

from __future__ import annotations

import torch

__all__ = ["exp_f32", "sigmoid_f32"]

_LOG2E = 1.44269504088896341
_C1 = 0.693359375
_C2 = -2.12194440e-4
_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
      1.6666665459e-1, 5.0000001201e-1)


def _f32(v: float) -> float:
    """``v`` rounded to the f32 value the lowering's constant holds."""
    return float(torch.tensor(v, dtype=torch.float32))


_F32_MIN_NORMAL = 2.0 ** -126
_LOG2E, _C1, _C2 = _f32(_LOG2E), _f32(_C1), _f32(_C2)
_P = tuple(_f32(p) for p in _P)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding (see the module docstring)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """e^x for an f32 tensor, bit for bit XLA:CPU's f32 ``exp``."""
    x = x.float().clamp(-87.8, 88.8)
    n = torch.floor(_fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    a = _fma(-n, _C1, x)
    a = _fma(-n, _C2, a)
    z = _fma(a, _P[0], _P[1])
    for p in _P[2:]:
        z = _fma(z, a, p)
    z = _fma(z, a * a, a)
    z = 1.0 + z
    # 2^n from its exponent bits; n = -127 gives the bit pattern of +0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    # XLA's CPU runtime flushes denormal results to zero
    return torch.where(out < _F32_MIN_NORMAL, 0.0, out)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + e^-x) in the reference's op order."""
    return 1.0 / (1.0 + exp_f32(-x))
