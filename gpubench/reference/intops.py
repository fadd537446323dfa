"""Exact integer arithmetic held in f32, in plain torch: the benchmark's
frozen copy of the integer engine's operations.

Every integer value is an f32 that holds it exactly; each division is the
correctly rounded f32 quotient (Dekker's residual over 12-bit splits), each
power of two a bit construction, each row sum two int32 limbs recombined in
a fixed f32 order, each root the correctly rounded f32 root.  These are the
operations the I-BERT (Kim et al., arXiv:2101.01321) and I-ViT (Li and Gu,
arXiv:2207.01405) integer nonlinearities are defined by, written out so
that the result does not depend on the device: torch's CUDA f32 ``sqrt`` is
not correctly rounded, and CUDA divides by a host scalar as a product with
its reciprocal, so divisors are tensors here and roots go through f64.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch

INT32_MAX = 2.0**31 - 1

# I-BERT constants (ibert_modules.py of the I-BERT reference)
GELU_K = 1.4142
GELU_N = 6
GELU_A = -0.2888
GELU_B = -1.769
GELU_C = 1.0 / GELU_A
EXP_X0 = -0.6931
EXP_N = 30
EXP_A = 0.35815147
EXP_B = 0.96963238 / EXP_A
EXP_C = 1.0 / EXP_A


def f32(x, device=None):
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float32 else x.float()
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _dev(*xs):
    return next((x.device for x in xs if isinstance(x, torch.Tensor)), None)


def _split(x):
    hi = (x.view(torch.int32) & -4096).view(torch.float32)
    return hi, x - hi


def rdiv(a, b):
    """Correctly rounded f32 ``a / b``."""
    d = _dev(a, b)
    a, b = f32(a, d), f32(b, d)
    q = a / b
    qh, ql = _split(q)
    bh, bl = _split(b)
    r = (((a - qh * bh) - qh * bl) - ql * bh) - ql * bl
    return q + r / b


def sqrt_rn(x):
    """Correctly rounded f32 square root."""
    r = torch.sqrt(x.double()).float()
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    rd, xd = r.double(), x.double()
    hi, lo = (rd + up.double()) * 0.5, (rd + down.double()) * 0.5
    return torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, down, r))


def floor_div_int(x, b):
    """Exact ``floor(x / b)`` of f32-held integers."""
    b = f32(b, x.device)
    q = torch.floor(x * (1.0 / b))
    rs = (x - q * b) * torch.sign(b)
    return q - (rs < 0).float() + (rs >= torch.abs(b)).float()


def pow2(k):
    """Exact 2**k for integer-valued f32 k in [-126, 127]."""
    ki = torch.clamp(k, -126, 127).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


def _two_sum(x, y):
    s = x + y
    yy = s - x
    return s, (x - (s - yy)) + (y - yy)


def exact_fma(a, b, c):
    """Correctly rounded ``a * b + c``."""
    d = _dev(a, b, c)
    a, b, c = f32(a, d), f32(b, d), f32(c, d)
    ah, al = _split(a)
    bh, bl = _split(b)
    s, e1 = _two_sum(c, ah * bh)
    s, e2 = _two_sum(s, ah * bl)
    s, e3 = _two_sum(s, al * bh)
    s, e4 = _two_sum(s, al * bl)
    return s + ((e1 + e2) + (e3 + e4))


def _limb_sum(v):
    return v.to(torch.int32).sum(dim=-1, keepdim=True).to(torch.int32).float()


def int_sum(x):
    """Last-axis sum (keepdim) of f32-held integers, in two int32 limbs."""
    x = torch.clamp(x, -(2.0**31), 2.0**31)
    h = torch.floor(x * (2.0**-8))
    lo = x - h * (2.0**8)
    return _limb_sum(h) * 2.0**8 + _limb_sum(lo)


def sq_sum(y):
    """Last-axis sum (keepdim) of squares of f32-held integers, in limbs."""
    a = torch.floor(y * (2.0**-8))
    b = y - a * (2.0**8)
    return (_limb_sum(a * a) * 2.0**16
            + (_limb_sum(a * b) * 2.0**9 + _limb_sum(b * b)))


# --- I-BERT ------------------------------------------------------------------

def ibert_exp(x, s, fast_q=False, fast_poly=False):
    """I-BERT's integer exp of x <= 0 at scale s: range reduction by -ln 2,
    a second-order polynomial, a shift."""
    s = f32(s, x.device)
    x0 = torch.floor(rdiv(EXP_X0, s))
    x = torch.maximum(x, EXP_N * x0)
    q = floor_div_int(x, x0) if fast_q else torch.floor(rdiv(x, x0))
    r = x - x0 * q
    b = torch.floor(rdiv(EXP_B, s))
    c = torch.floor(rdiv(EXP_C, s * s))
    z = r * (r + b) + c if fast_poly else exact_fma(r, r + b, c)
    return torch.clamp(torch.floor(z * pow2(EXP_N - q)), min=0)


def ibert_erf(x, s, fast_poly=False):
    """I-BERT's integer erf; returns (erf_int, its scale)."""
    s = f32(s, x.device)
    b = torch.floor(rdiv(GELU_B, s))
    c = torch.floor(rdiv(GELU_C, s * s))
    t = torch.minimum(torch.abs(x), -b) + b
    y = torch.sign(x) * (t * t + c if fast_poly else exact_fma(t, t, c))
    return torch.floor(y / 2**GELU_N), s * s * f32(GELU_A, s.device) * 2**GELU_N


def ibert_gelu(x, s, fast_poly=False):
    """I-BERT GELU: x * (erf(x / (s k)) + shift), integer."""
    s = f32(s, x.device)
    x = torch.round(x)
    sig, sig_scale = ibert_erf(x, rdiv(s, GELU_K), fast_poly)
    return x * (sig + torch.floor(rdiv(1.0, sig_scale)))


def ibert_softmax(x, s, s_exp_act, bits, fast_q=False, fast_poly=False):
    """I-BERT softmax of integer scores: exp, a 16-bit requant of the exps,
    the reciprocal of their exact row sum at 2**32."""
    x = torch.round(x)
    x = x - torch.amax(x, dim=-1, keepdim=True)
    e = ibert_exp(x, s, fast_q, fast_poly)
    e16 = torch.clamp(torch.round(e * rdiv(1.0, s_exp_act)), -(2.0**15), 2.0**15 - 1)
    factor = torch.floor(rdiv(2.0**32, int_sum(e16)))
    return torch.floor(e16 * factor / 2 ** (32 - bits + 1))


def ibert_layernorm(x, shift):
    """I-BERT LayerNorm of integer rows at a frozen overflow shift, without
    its affine part: floor(y * floor(2**31 / std) / 2), y = x - mean."""
    dim = x.shape[-1]
    x = torch.round(x)
    y = x - torch.round(rdiv(int_sum(x), f32(dim, x.device)))
    shift = f32(shift, x.device)
    pw = pow2(shift)
    var = sq_sum(torch.floor(y / pw))
    std = torch.floor(sqrt_rn(var)) * pw
    return torch.floor(y * torch.floor(rdiv(2.0**31, std)) / 2)


# --- I-ViT -------------------------------------------------------------------

def shift_exp(x, s, n, fast_q=False):
    """I-ViT's shift exp: 2**(x log2 e) by a quotient/remainder split."""
    s = f32(s, x.device)
    x = x + torch.floor(x / 2) - torch.floor(x / 2**4)
    x0 = torch.floor(rdiv(-1.0, s))
    x = torch.maximum(x, n * x0)
    q = floor_div_int(x, x0) if fast_q else torch.floor(rdiv(x, x0))
    r = x - x0 * q
    return torch.clamp(torch.floor((r / 2 - x0) * pow2(n - q)), min=0)


def shiftmax(x, s, bits, fast_q=False):
    """I-ViT Shiftmax of integer scores: probabilities at 2**-(bits-1)."""
    x = torch.round(x)
    x = x - torch.amax(x, dim=-1, keepdim=True)
    e = shift_exp(x, s, 15, fast_q)
    total = torch.clamp(int_sum(e), max=INT32_MAX)
    factor = torch.floor(rdiv(INT32_MAX, total))
    return torch.floor(e * factor / 2 ** (31 - bits + 1))


def shift_gelu(x, s, fast_q=False, bits=8, n=23):
    """I-ViT ShiftGELU: x * sigmoid(1.702 x) from two shift exps over the
    row's max."""
    s_sig = f32(s, x.device) * 1.702
    x = torch.round(x)
    m = torch.amax(x, dim=-1, keepdim=True)
    e = shift_exp(x - m, s_sig, n, fast_q)
    e_max = shift_exp(-m, s_sig, n, fast_q)
    factor = torch.floor(rdiv(INT32_MAX, torch.clamp(e + e_max, max=INT32_MAX)))
    return x * torch.floor(e * factor / 2 ** (31 - bits + 1))


def ivit_layernorm(x):
    """I-LayerNorm of integer rows without its affine part: the variance's
    root by ten integer Newton steps from 2**16."""
    x = torch.round(x)
    y = x - torch.round(rdiv(int_sum(x), f32(x.shape[-1], x.device)))
    var = sq_sum(y)
    k = torch.full_like(var, 2.0**16)
    for _ in range(10):
        k = torch.floor((k + torch.floor(rdiv(var, k))) / 2)
    return torch.floor(y * torch.floor(rdiv(INT32_MAX, k)) / 2)
