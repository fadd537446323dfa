"""Frozen-engine config and spec, plus the numpy freeze-time helpers
(counterpart of ``ivit_tpu/engine/freeze.py``).

``freeze_model`` itself needs the QAT sim and is not ported yet; the
helpers here are what :mod:`ivit_tpu_torch.engine.synthetic` and the
loader need.  The scale helpers are numpy f32 arithmetic, whose division
is correctly rounded and so bit-matches ``rdiv``; the ppoly fast-div gate
evaluates the port's own integer cores on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.registry import parse_layer_name
from ..models.vit import BitWidths
from ..ops import ibert as _ib
from ..ops.ppoly import eval_piecewise_poly, ppoly_gelu_int
from ..ops.quant import exp_fastdiv_ok

F32_EPS = float(np.finfo(np.float32).eps)


def _np(x):
    return np.asarray(x)


def _sym_scale(num_bits: int, x_min, x_max):
    """float32 scale exactly as the reference/trainer computes it."""
    n = np.float32(2 ** (num_bits - 1) - 1)
    mag = np.maximum(-_np(x_min).astype(np.float32),
                     _np(x_max).astype(np.float32))
    return np.maximum(mag / n, np.float32(F32_EPS))


def requant_multiplier(s_in, s_out) -> np.ndarray:
    """Correctly-rounded f32 ratio ``s_in / s_out`` -- the dyadic multiplier."""
    return (_np(s_in).astype(np.float32)
            / _np(s_out).astype(np.float32)).astype(np.float32)


def requant_const(z_int, s_in, s_out):
    """Freeze-time constant requant: f32 ``round(z * M)``."""
    m = requant_multiplier(s_in, s_out)
    return np.round(_np(z_int).astype(np.float32) * m)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static architecture + approximation selection of a frozen engine.

    Field for field the JAX ``EngineConfig``, so one artifact JSON loads
    into either package."""

    img_size: int
    patch_size: int
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float
    num_classes: int
    bitwidths: BitWidths
    gelu_type: str
    softmax_type: str
    layernorm_type: str
    qk_scale: Optional[float] = None
    fast_exp: bool = False
    fast_poly: bool = False
    use_lut: bool = False
    sm_sum_i32: bool = False
    ppoly_fastdiv: bool = False

    @property
    def head_dim(self):
        return self.embed_dim // self.num_heads

    @property
    def num_patches(self):
        return (self.img_size // self.patch_size) ** 2

    @property
    def attn_scale(self):
        return self.qk_scale or self.head_dim ** -0.5

    def base_type(self, which: str) -> str:
        name = {"gelu": self.gelu_type, "softmax": self.softmax_type,
                "ln": self.layernorm_type}[which]
        return parse_layer_name(name)[0]

    def type_params(self, which: str) -> dict:
        name = {"gelu": self.gelu_type, "softmax": self.softmax_type,
                "ln": self.layernorm_type}[which]
        return parse_layer_name(name)[1]


@dataclasses.dataclass
class EngineSpec:
    """Frozen integer network: static config + parameter tree (numpy arrays
    or torch tensors, see :func:`ivit_tpu_torch.engine.convert.params_to_torch`)."""

    config: EngineConfig
    params: Dict[str, Any]


def _exp_fast_gate(sm_base: str, gelu_base: str, s_attn, s_gelu) -> bool:
    """May every exp-chain quotient in a block use ``floor_div_int``?
    (freeze.py:154; ivit softmax n=15, ivit GELU n=23, ibert exp n=30)."""
    ok = True
    if sm_base == "ivit":
        x0 = np.floor(np.float32(-1.0) / np.float32(s_attn))
        ok = ok and exp_fastdiv_ok(x0, 15)
    elif sm_base == "ibert":
        x0 = np.floor(np.float32(_ib.EXP_X0) / np.float32(s_attn))
        ok = ok and exp_fastdiv_ok(x0, _ib.EXP_N)
    if gelu_base == "ivit":
        s_sig = np.float32(np.float32(s_gelu) * np.float32(1.702))
        x0 = np.floor(np.float32(-1.0) / s_sig)
        ok = ok and exp_fastdiv_ok(x0, 23)
    return bool(ok)


def _poly_fast_gate(sm_base: str, gelu_base: str, s_attn, s_gelu) -> bool:
    """May the block's ibert polynomials use the plain mul-add form?
    (freeze.py:228: every product and sum inside the f32-exact 2**24)."""
    lim = 2.0**24
    ok = True
    if sm_base == "ibert":
        s = np.float32(s_attn)
        x0 = abs(np.floor(np.float32(_ib.EXP_X0) / s))
        b = np.floor(np.float32(_ib.EXP_B) / s)
        c = abs(np.floor(np.float32(_ib.EXP_C) / np.float32(s * s)))
        ok = ok and bool(x0 * (x0 + abs(b)) + c < lim)
    if gelu_base == "ibert":
        se = np.float32(np.float32(s_gelu) / np.float32(_ib.GELU_K))
        b = abs(np.floor(np.float32(_ib.GELU_B) / se))
        c = abs(np.floor(np.float32(_ib.GELU_C) / np.float32(se * se)))
        ok = ok and bool(b * b + c < lim)
    return bool(ok)


# The bits of the GELU's input, the fc1 requant (``vit_int._mlp_unfused``
# and ``swin_int._mlp_unfused`` requant to it; the MLP kernels hold it as
# int8): the domain that the ppoly fast-div gate enumerates.
GELU_IN_BITS = 8
PPOLY_FASTDIV_PATCHES = 8


def ppoly_gelu_lut(bounds, coeffs, scale_bits: int, s_out) -> np.ndarray:
    """The ppoly GELU of every int8 input: ``U[x + 128] = floor(rdiv(
    poly(x) / 2**scale_bits, s_out))`` (``engine/luts.py:133``, the
    engine's rdiv form, whose values the fast-div gate must reproduce)."""
    x = torch.arange(256, dtype=torch.float32) - 128.0
    return ppoly_gelu_int(x, bounds, coeffs, scale_bits,
                          np.float32(s_out)).numpy()


def _ppoly_fastdiv_gate(bounds, coeffs, scale_bits: int, s_out,
                        in_bits: int = GELU_IN_BITS) -> tuple:
    """Exhaustive proof that the ppoly GELU epilogue divide is one
    multiply plus at most ``PPOLY_FASTDIV_PATCHES`` fixups
    (``freeze.py:182``).  The GELU input is the int8 fc1 requant, so all
    256 inputs are evaluated in both forms:

        fast:  g = floor(poly(x) * c),  c = fl(fl(1 / s_out) * 2**-sb)

    and every input where ``fast`` differs from the rdiv form becomes a
    patch ``g += (x == h_j) * d_j``.  Returns ``(ok, c, patch_h [P],
    patch_d [P])``, unused slots ``h = 2**30`` (never an int8 input).
    ``in_bits``: the bits of the GELU input; the proof covers 8 only, so
    any other width raises rather than void it."""
    if in_bits != 8:
        raise ValueError(f"the ppoly fast-div gate enumerates the int8 GELU "
                         f"input domain; got a {in_bits}-bit input")
    truth = ppoly_gelu_lut(bounds, coeffs, scale_bits, s_out)
    minv = np.float32(np.float32(1.0) / np.float32(s_out))
    c = np.float32(minv * np.float32(2.0 ** -scale_bits))
    x = np.arange(256, dtype=np.float32) - 128.0
    y_int = eval_piecewise_poly(torch.from_numpy(x), bounds, coeffs).numpy()
    fast = np.floor(y_int * c)
    bad = np.nonzero(truth != fast)[0]
    P = PPOLY_FASTDIV_PATCHES
    patch_h = np.full((P,), 2.0**30, np.float32)
    patch_d = np.zeros((P,), np.float32)
    if len(bad) > P:
        return False, c, patch_h, patch_d
    patch_h[:len(bad)] = x[bad]
    patch_d[:len(bad)] = (truth - fast)[bad]
    return True, c, patch_h, patch_d
