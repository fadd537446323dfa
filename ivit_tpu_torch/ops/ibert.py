"""I-BERT integer nonlinearities on f32-held integers (counterpart of
``ivit_tpu/ops/ibert.py``): the integer cores the engine calls and the
fake-quant wrappers of the QAT sim.

The engine's LayerNorm (:func:`ibert_layernorm_int`) runs with a frozen
shift and without the weight/bias fold (zero for its ``weight=1, bias=0``
call; the engine adds the frozen integer bias itself).  The sim's
(:func:`ibert_layernorm_affine_int`) folds its weight and bias and, while
calibrating, raises the shift where the variance would pass 2**32 (the
dynamic overflow shift, ``ibert.py:179``).  The cores carry JAX's
gradients, as ``ops/ivit.py`` does.
"""

from __future__ import annotations

import math

import torch

from .quant import (clip, exact_fma, exact_int_sum, exact_sq_sum, f32,
                    floor_div_int, floor_ste, pow2, rdiv, round_ste, sqrt_rn)

# --- GELU (int_erf) constants, ibert_modules.py:192-195 ---
GELU_K = 1.4142
GELU_N = 6
GELU_A = -0.2888
GELU_B = -1.769
GELU_C = 1.0 / GELU_A

# --- Softmax (int_exp) constants, ibert_modules.py:263-267 ---
EXP_X0 = -0.6931  # -ln 2
EXP_N = 30
EXP_A = 0.35815147
EXP_B = 0.96963238 / EXP_A
EXP_C = 1.0 / EXP_A


def int_polynomial(x_int, scaling_factor, fast_poly: bool = False):
    """2nd-order polynomial a(x+b)x + c in integer domain (ibert:275-283)."""
    s = f32(scaling_factor, x_int.device)
    b_int = torch.floor(rdiv(EXP_B, s)).detach()
    c_int = torch.floor(rdiv(EXP_C, s * s)).detach()
    if fast_poly:
        z = x_int * (x_int + b_int) + c_int
    else:
        z = exact_fma(x_int, x_int + b_int, c_int)
    return z, s * s * f32(EXP_A, s.device)


def int_exp(x_int, scaling_factor, n: int = EXP_N, fast_q: bool = False,
            fast_poly: bool = False):
    """I-BERT integer exp via range reduction by -ln2 (ibert:285-295)."""
    s = f32(scaling_factor, x_int.device)
    x0_int = torch.floor(rdiv(EXP_X0, s)).detach()
    x_int = torch.maximum(x_int, n * x0_int)
    if fast_q:
        q = floor_div_int(x_int, x0_int)
    else:
        q = floor_ste(rdiv(x_int, x0_int))
    r = x_int - x0_int * q
    exp_int, exp_scale = int_polynomial(r, s, fast_poly)
    exp_int = clip(floor_ste(exp_int * pow2(n - q)), 0)
    return exp_int, exp_scale / 2**n


def int_erf(x_int, scaling_factor, fast_poly: bool = False):
    """sign(x) * (a*(clamp(|x|,-b)+b)**2 + c) integer erf (ibert:203-218)."""
    s = f32(scaling_factor, x_int.device)
    b_int = torch.floor(rdiv(GELU_B, s)).detach()
    c_int = torch.floor(rdiv(GELU_C, s * s)).detach()
    sign = torch.sign(x_int).detach()
    t = torch.minimum(torch.abs(x_int), -b_int) + b_int
    y_int = sign * (t * t + c_int) if fast_poly else sign * exact_fma(t, t, c_int)
    y_int = floor_ste(y_int / 2**GELU_N)
    return y_int, s * s * f32(GELU_A, s.device) * 2**GELU_N


def ibert_gelu_int(x_int, scaling_factor, fast_poly: bool = False):
    """I-BERT GELU core on integer tensors (ibert:220-235).

    Returns ``(y_int, out_scale)``; ``y_int = x_int * (erf_int + shift)``.
    """
    x_int = round_ste(x_int)
    s = f32(scaling_factor, x_int.device)
    sigmoid_int, sigmoid_scale = int_erf(x_int, rdiv(s, GELU_K), fast_poly)
    shift_int = torch.floor(rdiv(1.0, sigmoid_scale)).detach()
    y_int = x_int * (sigmoid_int + shift_int)
    return y_int, s * sigmoid_scale / 2


def ibert_softmax_exp_int(x_int, scaling_factor, n_valid=None,
                          fast_q: bool = False, fast_poly: bool = False):
    """First half of I-BERT softmax on integer tensors (ibert:304-309).

    ``n_valid``: padded columns are excluded from the max and produce
    exactly zero exp."""
    x_int = round_ste(x_int)
    mask = None
    if n_valid is not None and n_valid != x_int.shape[-1]:
        col = torch.arange(x_int.shape[-1], device=x_int.device)
        mask = col < n_valid
        x_int = torch.where(mask, x_int, torch.full_like(x_int, -(2.0**23)))
    x_int = x_int - torch.amax(x_int, dim=-1, keepdim=True)
    exp_int, exp_scale = int_exp(x_int, scaling_factor, fast_q=fast_q,
                                 fast_poly=fast_poly)
    if mask is not None:
        exp_int = torch.where(mask, exp_int, torch.zeros_like(exp_int))
    return exp_int, exp_scale


def _log2_rn_slack(k: int) -> int:
    """How far below 2**24 the 24-bit mantissa of an f32 ``n`` in [2**(k-1),
    2**k) may start for ``log2(n)``, correctly rounded to f32, to reach
    ``k``: ``log2(n)`` then lies within half the f32 spacing below ``k``
    (2**(ceil(log2 k) - 25)) of it, ``floor(2**24 * (1 - 2**-half))``."""
    half = 2.0 ** (math.ceil(math.log2(k)) - 25) if k > 1 else 2.0 ** -25
    return math.floor(2**24 * -math.expm1(-half * math.log(2)))


_LOG2_SLACK = [_log2_rn_slack(k) for k in range(129)]   # 11 for k in 17-32


def floor_log2_rn(n):
    """``floor(log2(n))`` of f32 ``n`` >= 1, log2 correctly rounded to f32 as
    torch's CPU ``log2`` gives it for integers, computed exactly on any
    device: the exponent ``e`` of ``n``, plus one where the mantissa lies
    within the slack of 2**24 (``csrc/exact.cuh`` ``floor_log2_rn`` takes
    the same integer steps).  JAX's CPU ``log2`` (``log(n) / log(2)``) is
    not correctly rounded; the seeds it gives differ from these only where
    the Newton steps of :func:`int_bitlength_sqrt` end at the same value
    (``tests/test_torch_port_lut.py``)."""
    n = n.detach()
    m, e = torch.frexp(n)                      # n = m * 2**e, m in [0.5, 1)
    e = e.to(torch.int64) - 1
    mant = (m * 2.0**24).to(torch.int64)
    slack = torch.tensor(_LOG2_SLACK, dtype=torch.int64, device=n.device)
    up = mant >= 2**24 - slack[(e + 1).clamp(0, 128)]
    return (e + up.to(torch.int64)).to(torch.float32)


def int_bitlength_sqrt(n, iters: int = 4):
    """Vectorized integer sqrt, bit-length seed + Newton (ibert:85-109); the
    bit length from :func:`floor_log2_rn`, so that every device seeds
    alike."""
    mask = n > 0
    n = clip(n, 0)
    bits = floor_log2_rn(clip(n, 1)) + 1
    x = pow2(torch.ceil(bits / 2))
    for _ in range(iters):
        inv = floor_ste(rdiv(n, clip(x, 1)))
        x = floor_ste((x + inv) / 2)
    return torch.where(mask, x, torch.zeros_like(x))


def _ibert_ln(x_int, shift, use_int_sqrt, overflow_handling, batch_max=None):
    """The I-BERT LayerNorm core without its bias (ibert:112-158): returns
    ``(floor(y * floor(2**31 / std) / 2), shift)``, ``y = x - mean``.  With
    ``overflow_handling`` the shift is first raised, where the variance at
    the given shift reaches 2**32, to the least shift that brings every
    row's below it (the branchless ``set_shift`` of ``ibert.py:208-217``,
    the max over the whole batch; ``batch_max``: the function that takes
    the max of a local one over the batch's shards, where it is cut)."""
    dim = x_int.shape[-1]
    x_int = round_ste(x_int)
    mean_int = round_ste(rdiv(exact_int_sum(x_int), f32(dim, x_int.device)))
    y_int = x_int - mean_int
    shift = f32(shift, x_int.device)

    def var(s):
        return exact_sq_sum(floor_ste(y_int / pow2(s)))

    if overflow_handling:
        with torch.no_grad():
            raw_var = exact_sq_sum(y_int)
            needed = torch.amax(torch.ceil(torch.log2(sqrt_rn(raw_var / 2.0**32))))
            top = torch.amax(var(shift))
            if batch_max is not None:
                needed, top = batch_max(needed), batch_max(top)
            overflow = top >= 2.0**32
            shift = torch.where(overflow, torch.maximum(shift, needed), shift)
    var_int = var(shift)
    pw = pow2(shift)
    if use_int_sqrt:
        std = floor_ste(int_bitlength_sqrt(var_int)) * pw
    else:
        std = floor_ste(sqrt_rn(var_int)) * pw
    factor = floor_ste(rdiv(2.0**31, std))
    return floor_ste(y_int * factor / 2), shift


def ibert_layernorm_int(x_int, shift, use_int_sqrt: bool = False):
    """I-BERT LayerNorm core on integer tensors with a frozen ``shift``
    (ibert:112-158, ``overflow_handling=False``), the engine's form: no
    weight or bias.  Returns ``y_int``."""
    return _ibert_ln(x_int, shift, use_int_sqrt, False)[0]


def ibert_layernorm_affine_int(x_int, weight, bias, shift,
                               overflow_handling: bool = True,
                               use_int_sqrt: bool = False, batch_max=None):
    """The sim's I-BERT LayerNorm core (``ibert.py:179``): the bias folded
    through the per-channel weight, ``out_scale = sqrt(C) / 2**30 *
    weight``, and the dynamic overflow shift while ``overflow_handling``.
    Returns ``(y_int, out_scale, new_shift)``."""
    dev = x_int.device
    y_int, new_shift = _ibert_ln(x_int, shift, use_int_sqrt, overflow_handling,
                                 batch_max)
    out_scale = sqrt_rn(f32(x_int.shape[-1], dev)) / 2.0**30
    w, b = f32(weight, dev), f32(bias, dev)
    bias_int = torch.floor(rdiv(rdiv(b.detach(), w.detach()), out_scale))
    return y_int + bias_int, out_scale * w, new_shift


# ---------------------------------------------------------------------------
# Fake-quant wrappers (the QAT sim)
# ---------------------------------------------------------------------------

def ibert_gelu(x, scaling_factor):
    """I-BERT GELU on fake-quant floats (``ibert.py:120``)."""
    y_int, out_scale = ibert_gelu_int(rdiv(x, scaling_factor), scaling_factor)
    return y_int * out_scale, out_scale


def ibert_softmax_exp(x, scaling_factor):
    """First half of I-BERT softmax on fake-quant floats (``ibert.py:147``):
    ``(exp_int, exp_scale)``, for the caller's 16-bit requant."""
    return ibert_softmax_exp_int(rdiv(x, scaling_factor), scaling_factor)


def ibert_softmax_normalize(exp_int, output_bit: int):
    """Second half of I-BERT softmax (``ibert.py:156``): the 2**32
    reciprocal of the exact row sum; returns ``(probs, out_scale)``."""
    factor = floor_ste(rdiv(2.0**32, exact_int_sum(exp_int)))
    out_int = floor_ste(exp_int * factor / 2 ** (32 - output_bit + 1))
    out_scale = f32([2.0 / 2**output_bit], exp_int.device)
    return out_int * out_scale, out_scale


def ibert_layernorm(x, scaling_factor, weight, bias, shift,
                    overflow_handling: bool = True, use_int_sqrt: bool = False,
                    batch_max=None):
    """I-BERT LayerNorm on fake-quant floats (``ibert.py:233``; a plain
    divide, as JAX has it): returns ``(x_out, out_scale, new_shift,
    y_int)``."""
    y_int, out_scale, new_shift = ibert_layernorm_affine_int(
        x / scaling_factor, weight, bias, shift,
        overflow_handling=overflow_handling, use_int_sqrt=use_int_sqrt,
        batch_max=batch_max)
    return y_int * out_scale, out_scale, new_shift, y_int
