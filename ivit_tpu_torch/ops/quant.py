"""Exact f32 integer arithmetic (counterpart of ``ivit_tpu/ops/quant.py``,
inference forms only).

Every function here reproduces the JAX construction operation for
operation, so that the plain PyTorch engine and the CUDA kernels
(``csrc/exact.cuh``) give the reference's bits:

* ``rdiv`` and ``exact_fma`` keep the Dekker residual / two-product built
  from 12-bit bitmask splits.  PyTorch runs each elementwise op as its own
  kernel, so no multiply is contracted into a following add; the JAX forms
  are built so that contraction is value-neutral anyway.
* The two-limb sums keep their int32 limbs and their fixed f32
  recombination: they round twice above 2**24, and an int64 sum cast once
  to f32 would give other bits there.
* A scalar divisor is made a tensor on the operand's device before
  dividing: ATen's CUDA true-divide by a host scalar multiplies by a
  reciprocal, which is not the correctly rounded quotient.

JAX's ``pack_rows`` is a relayout for the TPU's lanes; the port applies the
per-row function directly.  The straight-through estimators and VJPs come
with the QAT sim.
"""

from __future__ import annotations

import math

import torch


def f32(x, device=None) -> torch.Tensor:
    """``x`` as an f32 tensor (a Python float or numpy value becomes one on
    ``device``)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float32 else x.float()
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def _split(x):
    """Bitmask split: x == hi + lo, hi keeping the top 12 mantissa bits."""
    hi = (x.view(torch.int32) & -4096).view(torch.float32)
    return hi, x - hi


def rdiv(a, b):
    """Correctly-rounded f32 division with JAX's Dekker residual step
    (``ivit_tpu/ops/quant.py::rdiv``)."""
    dev = _device(a, b)
    a, b = f32(a, dev), f32(b, dev)
    q = a / b
    qh, ql = _split(q)
    bh, bl = _split(b)
    r = (((a - qh * bh) - qh * bl) - ql * bh) - ql * bl
    return q + r / b


def floor_div_int(x, b):
    """Exact ``floor(x / b)`` for f32-held integers (``quant.floor_div_int``);
    equals ``floor(rdiv(x, b))`` whenever :func:`exp_fastdiv_ok` holds."""
    b = f32(b, x.device)
    q = torch.floor(x * (1.0 / b))
    r = x - q * b
    rs = r * torch.sign(b)
    return q - (rs < 0).float() + (rs >= torch.abs(b)).float()


def exp_fastdiv_ok(x0, n: int) -> bool:
    """Host-side freeze gate: may ``floor_div_int`` replace
    ``floor(rdiv(x, x0))`` for every ``x`` in ``[n*x0, 0]``?"""
    x0 = float(x0)
    if not (x0 < 0 and math.isfinite(x0)):
        return False
    return -x0 <= 2.0 ** (23 - int(math.floor(math.log2(n))))


def pow2(k):
    """Exact 2**k for integer-valued f32 ``k`` in [-126, 127] (a bit
    construction, not ``exp2``)."""
    ki = torch.clamp(k, -126, 127).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


def _two_sum(x, y):
    s = x + y
    yy = s - x
    return s, (x - (s - yy)) + (y - yy)


def exact_fma(a, b, c):
    """Correctly-rounded ``a*b + c`` (``quant.exact_fma``): Dekker
    two-product plus TwoSum chains, literally as the JAX form."""
    dev = _device(a, b, c)
    a, b, c = f32(a, dev), f32(b, dev), f32(c, dev)
    ah, al = _split(a)
    bh, bl = _split(b)
    s, e1 = _two_sum(c, ah * bh)
    s, e2 = _two_sum(s, ah * bl)
    s, e3 = _two_sum(s, al * bh)
    s, e4 = _two_sum(s, al * bl)
    return s + ((e1 + e2) + (e3 + e4))


def _limb_sum(v):
    """int32 last-axis sum (keepdims) of an integer-valued f32 limb, as f32."""
    return v.to(torch.int32).sum(dim=-1, keepdim=True).to(torch.int32).float()


def exact_int_sum(x):
    """Two-limb last-axis sum of integer-valued f32 (keepdims)."""
    x = torch.clamp(x, -(2.0**31), 2.0**31)
    h = torch.floor(x * (2.0**-8))
    l = x - h * (2.0**8)
    return _limb_sum(h) * 2.0**8 + _limb_sum(l)


def exact_sq_sum(y):
    """Two-limb last-axis sum of squares of integer-valued f32 (keepdims)."""
    a = torch.floor(y * (2.0**-8))
    b = y - a * (2.0**8)
    return (_limb_sum(a * a) * 2.0**16
            + (_limb_sum(a * b) * 2.0**9 + _limb_sum(b * b)))
