"""Freeze-time lookup tables of the 8-bit-domain nonlinearities
(counterpart of ``ivit_tpu/engine/luts.py``).

Every hot nonlinearity input is an int8 integer at a frozen scale, so each
exp / erf / polynomial tower is a 256-entry table over its whole domain.
The tables are built here on the port's own integer cores on the CPU,
which give the JAX package's bits; a freeze writes them into every spec,
as JAX's does, and the engine loads them and runs the towers (the LUT
paths are off by default in JAX's kernels too).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.ibert import GELU_K, int_erf, int_exp
from ..ops.ivit import int_exp_shift
from ..ops.ppoly import eval_piecewise_poly, ppoly_gelu_int
from ..ops.quant import rdiv

LUT_SIZE = 256


def _t(x):
    return torch.as_tensor(np.float32(x))


def _np(t) -> np.ndarray:
    return t.numpy().astype(np.float32)


def _diffs():
    """``x - x_max`` over the int8 domain: 0, -1, ..., -255."""
    return -torch.arange(LUT_SIZE, dtype=torch.float32)


def _int8():
    return torch.arange(LUT_SIZE, dtype=torch.float32) - 128.0


def shiftmax_exp_lut(s_attn) -> np.ndarray:
    """``T[i] = int_exp_shift(-i, s_attn, n=15)`` (``luts.py:60``)."""
    return _np(int_exp_shift(_diffs(), _t(s_attn), 15)[0])


def shift_gelu_exp_lut(s_gelu) -> np.ndarray:
    """``T[i] = int_exp_shift(-i, s_gelu * 1.702, n=23)`` (``luts.py:73``)."""
    return _np(int_exp_shift(_diffs(), _t(s_gelu) * 1.702, 23)[0])


def ibert_softmax_exp16_lut(s_attn, s_exp_act) -> np.ndarray:
    """``T[i] = clip(round(int_exp(-i, s_attn) * rdiv(1, s_exp_act)))``, the
    16-bit exp requant folded in (``luts.py:87``)."""
    exp_int, _ = int_exp(_diffs(), _t(s_attn))
    m = rdiv(1.0, _t(s_exp_act))
    return _np(torch.clamp(torch.round(exp_int * m), -(2.0**15), 2.0**15 - 1))


def ibert_gelu_lut(s_gelu) -> np.ndarray:
    """``U[x + 128] = erf_int(x) + shift``, so that the GELU is ``x *
    U[x + 128]`` (``luts.py:102``)."""
    erf_int, sig_scale = int_erf(_int8(), rdiv(_t(s_gelu), GELU_K))
    return _np(erf_int + torch.floor(rdiv(1.0, sig_scale)))


def ppoly_softmax_exp_lut(bounds, coeffs, exp_bits: int) -> np.ndarray:
    """``T[i] = floor(clip(poly(127 - i), 0) / 2**(31 - exp_bits))``
    (``luts.py:119``)."""
    y = torch.clamp(eval_piecewise_poly(127.0 + _diffs(), bounds, coeffs), min=0.0)
    return _np(torch.floor(y / 2.0 ** (30 - exp_bits + 1)))


def ppoly_gelu_lut(bounds, coeffs, scale_bits: int, s_out) -> np.ndarray:
    """``U[x + 128] = floor(rdiv(poly(x) / 2**scale_bits, s_out))``, the
    engine's rdiv form (``luts.py:133``)."""
    return _np(ppoly_gelu_int(_int8(), bounds, coeffs, scale_bits, np.float32(s_out)))


def swin_shift_sat(sm_base: str, s_attn, mask_min: float, s_exp_act=None):
    """Saturation gate of a shifted Swin block's masked softmax positions
    (``luts.py:150``): ``(ok, sat)``, whether the exp tower is one constant
    ``sat`` over the whole masked range ``d = x_max - (a + M)``, ``a`` and
    ``x_max`` in [-128, 127], ``M = mask_min`` (so ``d`` in [max(0, |M| -
    255), |M| + 255]), where it clamps its argument.  ppoly extrapolates its
    leftmost segment and never saturates: ``(False, 0.0)``."""
    if sm_base not in ("ivit", "ibert"):
        return False, np.float32(0.0)
    m = abs(float(mask_min))
    d = -torch.arange(max(0.0, m - 255.0), m + 256.0, dtype=torch.float32)
    if sm_base == "ivit":
        vals = int_exp_shift(d, _t(s_attn), 15)[0]
    else:
        vals = int_exp(d, _t(s_attn))[0]
        vals = torch.clamp(torch.round(vals * rdiv(1.0, _t(s_exp_act))),
                           -(2.0**15), 2.0**15 - 1)
    v = _np(vals)
    ok = bool(v.size > 0 and np.all(v == v[0]))
    return ok, (v[0] if ok else np.float32(0.0))


def sum_fits_int32(lut: np.ndarray, n: int) -> bool:
    """May the softmax exp row sum of ``n`` keys run as one int32
    reduction (``n * max|T| < 2**31``, ``luts.py:183``)?"""
    m = float(np.max(np.abs(lut))) if lut.size else 0.0
    return bool(n * m < 2.0**31)
