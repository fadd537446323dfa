"""I-BERT integer nonlinearities on f32-held integers (counterpart of
``ivit_tpu/ops/ibert.py``, the inference forms the engine calls).

LayerNorm runs with a frozen shift only (``overflow_handling=False`` in the
JAX package); the weight/bias fold of the JAX core is zero for the engine's
``weight=1, bias=0`` call, so the port leaves it out and the engine adds
the frozen integer bias itself.
"""

from __future__ import annotations

import torch

from .quant import exact_fma, exact_int_sum, exact_sq_sum, f32, floor_div_int
from .quant import pow2, rdiv

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
    b_int = torch.floor(rdiv(EXP_B, s))
    c_int = torch.floor(rdiv(EXP_C, s * s))
    if fast_poly:
        z = x_int * (x_int + b_int) + c_int
    else:
        z = exact_fma(x_int, x_int + b_int, c_int)
    return z, s * s * f32(EXP_A, s.device)


def int_exp(x_int, scaling_factor, n: int = EXP_N, fast_q: bool = False,
            fast_poly: bool = False):
    """I-BERT integer exp via range reduction by -ln2 (ibert:285-295)."""
    s = f32(scaling_factor, x_int.device)
    x0_int = torch.floor(rdiv(EXP_X0, s))
    x_int = torch.maximum(x_int, n * x0_int)
    if fast_q:
        q = floor_div_int(x_int, x0_int)
    else:
        q = torch.floor(rdiv(x_int, x0_int))
    r = x_int - x0_int * q
    exp_int, exp_scale = int_polynomial(r, s, fast_poly)
    exp_int = torch.clamp(torch.floor(exp_int * pow2(n - q)), min=0)
    return exp_int, exp_scale / 2**n


def int_erf(x_int, scaling_factor, fast_poly: bool = False):
    """sign(x) * (a*(clamp(|x|,-b)+b)**2 + c) integer erf (ibert:203-218)."""
    s = f32(scaling_factor, x_int.device)
    b_int = torch.floor(rdiv(GELU_B, s))
    c_int = torch.floor(rdiv(GELU_C, s * s))
    sign = torch.sign(x_int)
    t = torch.minimum(torch.abs(x_int), -b_int) + b_int
    y_int = sign * (t * t + c_int) if fast_poly else sign * exact_fma(t, t, c_int)
    y_int = torch.floor(y_int / 2**GELU_N)
    return y_int, s * s * f32(GELU_A, s.device) * 2**GELU_N


def ibert_gelu_int(x_int, scaling_factor, fast_poly: bool = False):
    """I-BERT GELU core on integer tensors (ibert:220-235).

    Returns ``(y_int, out_scale)``; ``y_int = x_int * (erf_int + shift)``.
    """
    x_int = torch.round(x_int)
    s = f32(scaling_factor, x_int.device)
    sigmoid_int, sigmoid_scale = int_erf(x_int, rdiv(s, GELU_K), fast_poly)
    shift_int = torch.floor(rdiv(1.0, sigmoid_scale))
    y_int = x_int * (sigmoid_int + shift_int)
    return y_int, s * sigmoid_scale / 2


def ibert_softmax_exp_int(x_int, scaling_factor, n_valid=None,
                          fast_q: bool = False, fast_poly: bool = False):
    """First half of I-BERT softmax on integer tensors (ibert:304-309).

    ``n_valid``: padded columns are excluded from the max and produce
    exactly zero exp."""
    x_int = torch.round(x_int)
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


def int_bitlength_sqrt(n, iters: int = 4):
    """Vectorized integer sqrt, bit-length seed + Newton (ibert:85-109)."""
    mask = n > 0
    n = torch.clamp(n, min=0)
    bits = torch.floor(torch.log2(torch.clamp(n, min=1))) + 1
    x = pow2(torch.ceil(bits / 2))
    for _ in range(iters):
        inv = torch.floor(rdiv(n, torch.clamp(x, min=1)))
        x = torch.floor((x + inv) / 2)
    return torch.where(mask, x, torch.zeros_like(x))


def ibert_layernorm_int(x_int, shift, use_int_sqrt: bool = False):
    """I-BERT LayerNorm core on integer tensors with a frozen ``shift``
    (ibert:112-158, ``overflow_handling=False``).  Returns ``y_int``."""
    dim = x_int.shape[-1]
    x_int = torch.round(x_int)
    mean_int = torch.round(rdiv(exact_int_sum(x_int), f32(dim, x_int.device)))
    y_int = x_int - mean_int
    pw = pow2(f32(shift, x_int.device))
    var_int = exact_sq_sum(torch.floor(y_int / pw))
    if use_int_sqrt:
        std = torch.floor(int_bitlength_sqrt(var_int)) * pw
    else:
        std = torch.floor(torch.sqrt(var_int)) * pw
    factor = torch.floor(rdiv(2.0**31, std))
    return torch.floor(y_int * factor / 2)
