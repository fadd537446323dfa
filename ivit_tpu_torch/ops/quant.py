"""Exact f32 integer arithmetic and the QAT sim's quantizers (counterpart of
``ivit_tpu/ops/quant.py``).

Every function here reproduces the JAX construction operation for
operation, so that the QAT sim, the plain PyTorch engine and the CUDA
kernels (``csrc/exact.cuh``) give the reference's bits:

* ``rdiv`` and ``exact_fma`` keep the Dekker residual / two-product built
  from 12-bit bitmask splits.  PyTorch eager runs each elementwise op as
  its own kernel, so no multiply is contracted into a following add: JAX's
  ``_pin`` and ``mul_add_2r`` exist only against XLA's contraction, and the
  port writes the two-rounding form as two ops.  The sim must therefore
  never go through ``torch.compile``, whose fused kernels may contract.
* The two-limb sums keep their int32 limbs and their fixed f32
  recombination: they round twice above 2**24, and an int64 sum cast once
  to f32 would give other bits there.
* A scalar divisor is made a tensor on the operand's device before
  dividing: ATen's CUDA true-divide by a host scalar multiplies by a
  reciprocal, which is not the correctly rounded quotient.

JAX's ``pack_rows`` is a relayout for the TPU's lanes; the port applies the
per-row function directly.

The straight-through estimators (``floor_ste``, ``round_ste``), ``pow2``'s
gradient, the sums' backward rules and the three requant VJPs are
``torch.autograd.Function``s with JAX's rules.  Each dispatches to the
plain op when no gradient is being recorded, so the engine pays nothing
for them.  ``clip`` is ``jnp.clip``'s maximum-then-minimum, whose gradient
splits 1/2 at a bound (``torch.clamp`` passes all of it).
"""

from __future__ import annotations

import math

import torch

from ..utils.spans import span


def f32(x, device=None) -> torch.Tensor:
    """``x`` as an f32 tensor (a Python float or numpy value becomes one on
    ``device``).  Made on a device other than the CPU, it is a copy from
    the host's pageable memory, after which torch waits for the device's
    stream: the span ``ivit.sync``."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float32 else x.float()
    if device is None or getattr(device, "type", device) == "cpu":
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    with span("ivit.sync"):
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


def true_divide(x, scalar: float):
    """``x / scalar``, a correctly rounded f32 division on every device: the
    divisor a tensor on ``x``'s device, since CUDA divides by a host scalar
    as a product with its reciprocal, which rounds otherwise."""
    return x / torch.tensor(scalar, dtype=x.dtype, device=x.device)


def _sqrt_rn_value(x):
    # an f64 root rounded to f32 is within an ulp of the correctly rounded
    # one; the midpoints between it and its neighbours, squared, are exact
    # in f64 (25-bit factors) and never an f32, so comparing x with them
    # picks the correctly rounded root
    r = torch.sqrt(x.double()).float()
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    rd, xd = r.double(), x.double()
    hi, lo = (rd + up.double()) * 0.5, (rd + down.double()) * 0.5
    return torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, down, r))


class _SqrtRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _sqrt_rn_value(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / (2 * y)


def sqrt_rn(x):
    """Correctly rounded f32 ``sqrt``, as XLA's and the kernels'
    ``__fsqrt_rn``; gradient ``torch.sqrt``'s.  torch's f32 ``sqrt`` is not
    correctly rounded on the card (on an NVIDIA H100, an ulp off for 217
    of the 25,088 LayerNorm variances of a Swin-T ibert block, which moved
    a ``floor(sqrt)``), nor on an x86 CPU for large tensors (its vector
    math library: 6,606 of 2**20 integers below 2**32)."""
    return _SqrtRN.apply(x) if _grad_on(x) else _sqrt_rn_value(x)


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


LN2 = 0.6931471805599453


def _grad_on(*xs) -> bool:
    """Is autograd recording a graph through any of ``xs``?"""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _pow2_value(k):
    ki = torch.clamp(k, -126, 127).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


class _Pow2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k):
        y = _pow2_value(k)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return (LN2 * y) * g


def pow2(k):
    """Exact 2**k for integer-valued f32 ``k`` in [-126, 127] (a bit
    construction, not ``exp2``); gradient ``ln2 * 2**k``, as torch's
    ``2**k`` and JAX's ``pow2`` jvp."""
    return _Pow2.apply(k) if _grad_on(k) else _pow2_value(k)


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


def _exact_int_sum(x):
    x = torch.clamp(x, -(2.0**31), 2.0**31)
    h = torch.floor(x * (2.0**-8))
    l = x - h * (2.0**8)
    return _limb_sum(h) * 2.0**8 + _limb_sum(l)


def _exact_sq_sum(y):
    a = torch.floor(y * (2.0**-8))
    b = y - a * (2.0**8)
    return (_limb_sum(a * a) * 2.0**16
            + (_limb_sum(a * b) * 2.0**9 + _limb_sum(b * b)))


class _ExactIntSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return _exact_int_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.shape)


class _ExactSqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return _exact_sq_sum(y)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return (2.0 * y) * g


def exact_int_sum(x):
    """Two-limb last-axis sum of integer-valued f32 (keepdims); gradient
    that of ``sum`` (``quant.py:473``)."""
    return _ExactIntSum.apply(x) if _grad_on(x) else _exact_int_sum(x)


def exact_sq_sum(y):
    """Two-limb last-axis sum of squares of integer-valued f32 (keepdims);
    gradient ``2 y g`` (``quant.py:512``)."""
    return _ExactSqSum.apply(y) if _grad_on(y) else _exact_sq_sum(y)


# ---------------------------------------------------------------------------
# Straight-through estimators and clipping (the QAT sim's gradients)
# ---------------------------------------------------------------------------

class _FloorSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.floor(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def floor_ste(x):
    """floor with identity gradient (``quant.py:305``)."""
    return _FloorSTE.apply(x) if _grad_on(x) else torch.floor(x)


def round_ste(x):
    """round-half-to-even with identity gradient (``quant.py:346``)."""
    return _RoundSTE.apply(x) if _grad_on(x) else torch.round(x)


def clip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``.  The values of
    ``torch.clamp``, and, where a gradient is recorded, JAX's gradient,
    which splits 1/2 where ``x`` sits on a bound (``torch.clamp`` passes
    all of it)."""
    if not _grad_on(x):
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, f32(lo, x.device))
    if hi is not None:
        x = torch.minimum(x, f32(hi, x.device))
    return x


# ---------------------------------------------------------------------------
# Scales, fake quantization and the dyadic requant (QAT sim)
# ---------------------------------------------------------------------------

F32_EPS = float(torch.finfo(torch.float32).eps)


def ema_update(old, new, m: float):
    """``fl(old*m + fl(new*(1-m)))`` from two :func:`exact_fma` calls, the
    activation-range EMA (``quant.py:86``)."""
    return exact_fma(old, m, exact_fma(new, 1.0 - m, 0.0))


def symmetric_quant_params(num_bits: int, x_min, x_max):
    """Symmetric scale ``max(-min, max) / (2**(b-1) - 1)`` by ``rdiv``,
    clamped at f32 eps; no gradient (``quant.py:366``)."""
    n = 2 ** (num_bits - 1) - 1
    mag = torch.maximum(-x_min, x_max)
    return torch.clamp(rdiv(mag, float(n)), min=F32_EPS).detach()


def quantize_int(x, num_bits: int, scale):
    """``clip(round(x / scale), -2**(b-1), 2**(b-1) - 1)`` with gradient
    ``g / scale`` through ``rdiv`` (``quant.py:386``); integer-valued f32.
    ``scale`` must broadcast against ``x``."""
    n = 2 ** (num_bits - 1) - 1
    x_int = round_ste(rdiv(x, scale.detach()))
    return clip(x_int, -n - 1, n)


def fake_quantize(x, num_bits: int, scale):
    """``quantize_int(x) * scale``; overall straight-through gradient."""
    scale = scale.detach()
    return quantize_int(x, num_bits, scale) * scale


def _requant_value(num_bits, x, pre_scale, out_scale, identity=None,
                   identity_scale=None, z_int=None):
    """``round(z * M)`` with ``M = fl32(pre_scale / out_scale)`` (and the
    identity branch's own term), clipped, times ``out_scale``
    (``quant.py:533``; ``z_int`` given: the LN edges' exact integer,
    ``quant.py:599``)."""
    n = 2 ** (num_bits - 1) - 1
    z = torch.round(rdiv(x, pre_scale)) if z_int is None else z_int
    out = torch.round(z * rdiv(pre_scale, out_scale))
    if identity is not None:
        zi = torch.round(rdiv(identity, identity_scale))
        out = out + torch.round(zi * rdiv(identity_scale, out_scale))
    if num_bits in (4, 8, 16, 32):
        out = torch.clamp(out, -n - 1, n)
    return out * out_scale


class _Requant(torch.autograd.Function):
    """Gradient identity to ``x``, none to the scales (``quant.py:560``)."""

    @staticmethod
    def forward(ctx, num_bits, x, pre_scale, out_scale):
        return _requant_value(num_bits, x, pre_scale, out_scale)

    @staticmethod
    def backward(ctx, g):
        return None, g, None, None


class _RequantId(torch.autograd.Function):
    """Gradient identity to ``x`` and ``identity`` (``quant.py:578``)."""

    @staticmethod
    def forward(ctx, num_bits, x, pre_scale, out_scale, identity, identity_scale):
        return _requant_value(num_bits, x, pre_scale, out_scale, identity,
                              identity_scale)

    @staticmethod
    def backward(ctx, g):
        return None, g, None, None, g, None


class _RequantExact(torch.autograd.Function):
    """Requant from the producer's exact integer; gradient identity to
    ``x``, none to the integer (``quant.py:599``)."""

    @staticmethod
    def forward(ctx, num_bits, x, z_int, pre_scale, out_scale):
        return _requant_value(num_bits, x, pre_scale, out_scale, z_int=z_int)

    @staticmethod
    def backward(ctx, g):
        return None, g, None, None, None


def fixedpoint_requant(x, pre_scale, num_bits: int, out_scale, identity=None,
                       identity_scale=None, exact_int=None):
    """Fake-quant dyadic requantization with the optional fused residual
    add (``quant.py:638``): ``clip(round(round(x / pre) * M) [+ the same of
    the identity]) * out``.  Straight-through gradient to ``x`` and
    ``identity``, none to the scales."""
    pre_scale, out_scale = pre_scale.detach(), out_scale.detach()
    if exact_int is not None:
        if identity is not None:
            raise ValueError("exact_int requant has no identity branch "
                             "(LN edges carry no residual)")
        exact_int = exact_int.detach()
        if _grad_on(x):
            return _RequantExact.apply(num_bits, x, exact_int, pre_scale, out_scale)
        return _requant_value(num_bits, x, pre_scale, out_scale, z_int=exact_int)
    if identity is None:
        if _grad_on(x):
            return _Requant.apply(num_bits, x, pre_scale, out_scale)
        return _requant_value(num_bits, x, pre_scale, out_scale)
    identity_scale = identity_scale.detach()
    if _grad_on(x, identity):
        return _RequantId.apply(num_bits, x, pre_scale, out_scale, identity,
                                identity_scale)
    return _requant_value(num_bits, x, pre_scale, out_scale, identity,
                          identity_scale)
