"""I-ViT integer nonlinearities on f32-held integers: Shiftmax, ShiftGELU,
I-LayerNorm (counterpart of ``ivit_tpu/ops/ivit.py``): the integer cores
the engine calls and the fake-quant wrappers of the QAT sim.

Every value is an integer held in f32; powers of two are the exact ``pow2``
bit construction and every division is ``rdiv``, so the results are the JAX
package's bits.  The cores carry JAX's gradients: ``floor_ste`` /
``round_ste`` and the detached constants where JAX has them, and ``clip``
for ``jnp.clip``; without a gradient they are the plain ops.
"""

from __future__ import annotations

import torch

from .quant import (clip, exact_int_sum, exact_sq_sum, f32, floor_div_int,
                    floor_ste, pow2, rdiv, round_ste, sqrt_rn)

INT32_MAX = 2.0**31 - 1     # 2**31 once rounded to f32, as in the reference


def int_exp_shift(x_int, scaling_factor, n: int, fast_q: bool = False):
    """Shift-based integer exp, 2**(x * log2 e) by a quotient/remainder
    split (``ivit.py:38``; n = 15 for Shiftmax, 23 for ShiftGELU).

    ``x_int``: integer-valued f32 (<= 0 after the row max is subtracted);
    ``fast_q``: the divide-free exact quotient the freeze step gates.
    Returns ``(exp_int, scale / 2**n)``."""
    s = f32(scaling_factor, x_int.device)
    x_int = x_int + floor_ste(x_int / 2) - floor_ste(x_int / 2**4)
    x0_int = torch.floor(rdiv(-1.0, s)).detach()
    x_int = torch.maximum(x_int, n * x0_int)
    q = floor_div_int(x_int, x0_int) if fast_q else floor_ste(rdiv(x_int, x0_int))
    r = x_int - x0_int * q
    exp_int = r / 2 - x0_int
    exp_int = clip(floor_ste(exp_int * pow2(n - q)), 0)
    return exp_int, s / 2**n


def shiftmax_int(x_int, scaling_factor, output_bit: int = 8, n_valid=None,
                 fast_q: bool = False):
    """Shiftmax core (``ivit.py:74``): probs in [0, 2**(bit-1)] at the fixed
    scale ``2**-(bit-1)``.  ``n_valid``: columns >= n_valid are padding,
    kept out of the max and given probability exactly 0."""
    x_int = round_ste(x_int)
    mask = None
    if n_valid is not None and n_valid != x_int.shape[-1]:
        mask = torch.arange(x_int.shape[-1], device=x_int.device) < n_valid
        x_int = torch.where(mask, x_int, torch.full_like(x_int, -(2.0**23)))
    x_int = x_int - torch.amax(x_int, dim=-1, keepdim=True)
    exp_int, _ = int_exp_shift(x_int, scaling_factor, 15, fast_q)
    if mask is not None:
        exp_int = torch.where(mask, exp_int, torch.zeros_like(exp_int))
    exp_sum = clip(exact_int_sum(exp_int), hi=INT32_MAX)
    factor = floor_ste(rdiv(INT32_MAX, exp_sum))
    probs = floor_ste(exp_int * factor / 2 ** (31 - output_bit + 1))
    return probs, f32([1.0 / 2 ** (output_bit - 1)], x_int.device)


def shift_gelu_int(pre_x_int, scaling_factor, output_bit: int = 8, n: int = 23,
                   fast_q: bool = False, row_max=None):
    """ShiftGELU core (``ivit.py:102``): ``x * sigmoid(1.702 x)`` with the
    sigmoid from two shift exps; the row max runs over the whole last axis
    (``row_max``: the function that takes it, where the row is cut in
    shards; ``amax`` by default).  Returns ``(y_int, scale * 2**-(bit-1))``."""
    s = f32(scaling_factor, pre_x_int.device)
    s_sig = s * 1.702
    pre_x_int = round_ste(pre_x_int)
    if row_max is None:
        x_max = torch.amax(pre_x_int, dim=-1, keepdim=True)
    else:
        x_max = row_max(pre_x_int)
    exp_int, _ = int_exp_shift(pre_x_int - x_max, s_sig, n, fast_q)
    exp_max, _ = int_exp_shift(-x_max, s_sig, n, fast_q)
    exp_sum = clip(exp_int + exp_max, hi=INT32_MAX)
    factor = floor_ste(rdiv(INT32_MAX, exp_sum))
    sigmoid_int = floor_ste(exp_int * factor / 2 ** (31 - output_bit + 1))
    return pre_x_int * sigmoid_int, s / 2 ** (output_bit - 1)


def int_newton_sqrt(var_int, iters: int = 10, k0: float = 2.0**16):
    """Integer Newton sqrt, k <- floor((k + floor(v / k)) / 2), seeded at
    2**16 (``ivit.py:130``)."""
    k = torch.full_like(var_int, k0)
    for _ in range(iters):
        k = floor_ste((k + floor_ste(rdiv(var_int, k))) / 2)
    return k


def i_layernorm_centered(x_int):
    """I-LayerNorm's centred integers ``y = x - round(mean)`` (the engine's
    envelope audit reads them, ``vit_int.py:452``)."""
    x_int = round_ste(x_int)
    dim = f32(x_int.shape[-1], x_int.device)
    return x_int - round_ste(rdiv(exact_int_sum(x_int), dim))


def i_layernorm_core(x_int):
    """The integer part of I-LayerNorm, without its bias: ``floor(y *
    floor(INT32_MAX / newton_sqrt(var)) / 2)`` with ``y = x - mean``; the
    engine adds the frozen integer bias (``vit_int.py:441-457``)."""
    y_int = i_layernorm_centered(x_int)
    factor = floor_ste(rdiv(INT32_MAX, int_newton_sqrt(exact_sq_sum(y_int))))
    return floor_ste(y_int * factor / 2)


def i_layernorm_int(x_int, weight, bias):
    """I-LayerNorm core (``ivit.py:141``): returns ``(y_int, out_scale)``
    with the bias folded through the per-channel weight and the scale
    ``sqrt(C) / 2**30 * weight``."""
    dev = x_int.device
    out_scale = sqrt_rn(f32(x_int.shape[-1], dev)) / 2.0**30
    w, b = f32(weight, dev), f32(bias, dev)
    bias_int = torch.floor(rdiv(rdiv(b.detach(), w.detach()), out_scale))
    return i_layernorm_core(x_int) + bias_int, out_scale * w


# ---------------------------------------------------------------------------
# Fake-quant wrappers (the QAT sim)
# ---------------------------------------------------------------------------

def shiftmax(x, scaling_factor, output_bit: int = 8):
    """Shiftmax on fake-quant floats (``ivit.py:179``): the core on the
    quotient ``rdiv(x, s)``, returns ``(probs, out_scale)``."""
    probs_int, out_scale = shiftmax_int(rdiv(x, scaling_factor), scaling_factor,
                                        output_bit)
    return probs_int * out_scale, out_scale


def shift_gelu(x, scaling_factor, output_bit: int = 8, n: int = 23,
               row_max=None):
    """ShiftGELU on fake-quant floats (``ivit.py:187``)."""
    y_int, out_scale = shift_gelu_int(rdiv(x, scaling_factor), scaling_factor,
                                      output_bit, n, row_max=row_max)
    return y_int * out_scale, out_scale


def i_layernorm(x, scaling_factor, weight, bias):
    """I-LayerNorm on fake-quant floats (``ivit.py:194``): returns ``(x_out,
    out_scale, y_int)``, the exact integer riding along for the next
    requant (LN integers pass the f32-exact 2**24)."""
    y_int, out_scale = i_layernorm_int(rdiv(x, scaling_factor), weight, bias)
    return y_int * out_scale, out_scale, y_int
