"""The engines' three fused half-block kernels, ivit, ibert and ppoly
families, for Hopper.

``mlp_block`` replaces ``ivit_tpu/ops/pallas/block.py::mlp_block_p`` (the
ViT form on int8 token rows and the Swin form on int16 rows),
``attn_block`` replaces ``attn_block_p`` and ``swin_attn_block`` replaces
``swin_attn_block_p``.  Each wrapper launches the hand-written CUDA kernel
(``ivit_tpu_torch/csrc/``) for a tensor on the card and runs its plain
PyTorch version, ``mlp_block_ref`` / ``attn_block_ref`` /
``swin_attn_block_ref``, for a tensor on the CPU.  The plain versions
follow the Pallas kernel bodies (``_mlp_kernel``, ``_attn_kernel``,
``_swin_attn_kernel``) step for step and run on either device; on the card
they are what the kernels are held against.

On the card every operand is a tensor there, the scalars (LN shift,
scales, multipliers) one-element f32 tensors as the engine spec holds
them: the kernels derive their constants from those in each thread, so
a call launches nothing but the weight transposes and the kernel
(``mlp_block`` takes the transposes as ``fc1_wt`` / ``fc2_wt``, which
``Engine`` makes once, and then launches the kernel alone, after its
ShiftGELU table with the ivit GELU).

Each wrapper counts its kernel launches in a plain integer attribute
(``mlp_block.launches``, ``attn_block.launches``,
``swin_attn_block.launches``), incremented only where the kernel is
launched, and those of its table form and of its integer-sqrt LN apart as
well (``lut_launches``, ``int_sqrt_launches``), and the weight transposes it
makes inside the call (``transposes``: two a call of ``attn_block`` and
``swin_attn_block``, one for each of ``fc1_wt`` / ``fc2_wt`` that a
``mlp_block`` call is not handed).  The whole of each wrapper call (checks,
argument structs, transposes, table and kernel launches; the plain version
on the CPU) is the span ``ivit.kernel.<wrapper>``
(:mod:`ivit_tpu_torch.utils.spans`: recorded only while a profiler records).

Each kernel takes its LayerNorm from the ivit or ibert family and its
softmax and GELU from the ivit, ibert or ppoly family, in any mix
(``ln_base``, ``sm_base``, ``gelu_base``), and either runs the LN itself
or takes its int8 output as ``ln_in`` (the JAX kernels' hoisted LN,
``block.py`` ``hoisted_ln``), which skips the LN stage.  The ppoly
variants take the fitted table's spec leaves as JAX's kernels do
(``gelu_bounds`` / ``gelu_coeffs`` and the GELU's output grid and fast-div
constants; ``sm_bounds`` / ``sm_coeffs`` and ``exp_bits``); on the card a
256-entry table of the call, one small launch before the kernel, holds
the GELU + requant of every int8 input or the exp of every int8 offset
(``csrc/ppoly.cuh``).

The ViT kernels take the token stream in and out as int8 or int16, each
in its own container: the reference's INT16 configuration (bitwidths
``8,8,8,8,16,8,16,8``) has ``attn_block`` take int8 x to an int16 output
at 16-bit probabilities (``sm_bit`` 16; P v then runs as two exact 8-bit
tensor-core products, ``csrc/attn_chain.cuh``) and ``mlp_block`` take the
int16 rows back to int8.  Probabilities go into their container saturating
at its top (:func:`to_container`), as the reference's conversion does.

Padding rows (token index >= ``n_valid``) may hold anything: their scores
columns are masked out of the softmax and their LN output, NaN for an
all-zero ibert row, is pinned to 0.  Only valid rows of the output are
defined.

The kernels take any channel count C that is a multiple of 32 (at most
1024) whose GEMM widths share a pass of 128, 96 or 64 columns: DeiT-S's
384 and Swin-T's 96 to 768 run as they are.  The TPU kernels' lane padding
of C to 128 (``c_valid``) is a Mosaic layout workaround, not semantics,
and the port has none.

The ibert LayerNorm takes I-BERT's integer sqrt where ``use_int_sqrt`` asks
for it (the JAX kernels take floor(sqrt) whatever the flag; the port's
follow the unfused engine, which honours it).

The freeze-time tables (``engine/luts.py``) replace the towers where a
spec's ``gelu_lut`` / ``sm_lut`` is passed and ``IVIT_LUT`` is set (read at
each call, off by default, as ``block.py:347`` reads it): the softmax exp
as ``sm_lut[clip(max - x, 0, 255)]`` (Swin's shifted blocks take
``sm_sat`` where the shift mask is negative), the ivit row sum one int32
reduction under ``sm_sum_i32``; the GELU as ShiftGELU's per-row sigmoid of
``gelu_lut``'s exps, ibert's ``x * U[x + 128]`` or ppoly's ``U[x + 128]``.
The tables hold the towers' own values, so the bits are the same unless a
table is changed.  Where the gate says tower (no table, ``IVIT_LUT`` unset,
a shifted Swin block without ``sm_sat``), the towers run, as in JAX.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ...utils.spans import spanned
from .. import ibert as ib
from .. import ivit as iv
from .. import ppoly as pp
from ..quant import exact_int_sum, rdiv
from . import _build


def int8_matmul(a, w):
    """Exact int8 x int8 -> int32 product over the last axis of ``a``.

    torch's int8 matmul wraps in int8, and CUDA has no integer matmul: on
    the CPU the operands go to int32, on the card to float64, where every
    partial sum of int8 products is an exact integer (< 2**53)."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ w.to(torch.int32)
    return torch.round(a.double() @ w.double()).to(torch.int32)


def container(bits):
    """Narrowest signed integer dtype holding a ``bits``-clamped value."""
    return torch.int8 if bits <= 8 else (torch.int16 if bits <= 16 else torch.int32)


def to_container(x, bits):
    """f32-held integers into the ``bits`` container, saturating at its
    range as the reference's f32 -> int conversion (XLA's) does: a
    probability of 2**(bits - 1), which a one-hot row's exp * factor can
    round to, becomes 2**(bits - 1) - 1, where torch's conversion would wrap
    it (the kernels saturate alike)."""
    dt = container(bits)
    return torch.clamp(x, torch.iinfo(dt).min, torch.iinfo(dt).max).to(dt)


def _pass_width(n1, n2):
    """The GEMM output pass the kernels take for widths n1 and n2 (128, 96
    or 64 columns, the widest dividing both; 0 if none does), as
    ``exact.cuh::pass_width``."""
    return next((w for w in (128, 96, 64) if n1 % w == 0 and n2 % w == 0), 0)


def _requant(acc, m, bits):
    """``clip(round(acc * m))`` to a ``bits`` signed range, f32-held."""
    lim = 2.0 ** (bits - 1)
    return torch.clamp(torch.round(acc.float() * m), -lim, lim - 1)


def _residual(y2, m_res_x, x, m_res_id, bits):
    lim = 2.0 ** (bits - 1)
    out = torch.clamp(torch.round(y2 * m_res_x) + torch.round(x.float() * m_res_id),
                      -lim, lim - 1)
    return out.to(container(bits))


def _ln8(x, ln_base, ln_bias, ln_shift, m_ln, ln_in, use_int_sqrt=False):
    """LayerNorm + bias + int8 requant of ``x`` (I-LayerNorm or the ibert LN
    with its frozen shift, floor(sqrt) or, with ``use_int_sqrt``, I-BERT's
    integer sqrt; a NaN ibert row, zero variance, -> 0), or the hoisted
    ``ln_in`` as it is."""
    if ln_in is not None:
        return ln_in
    if ln_base == "ivit":
        y = iv.i_layernorm_core(x.float()) + ln_bias
    else:
        y = ib.ibert_layernorm_int(x.float(), ln_shift,
                                   use_int_sqrt=use_int_sqrt) + ln_bias
        y = torch.where(torch.isnan(y), torch.zeros_like(y), y)
    return _requant(y, m_ln, 8).to(torch.int8)


_FAMILIES = ("ivit", "ibert", "ppoly")   # softmax and GELU
PPOLY_MAX_SEG, PPOLY_MAX_DEG = 64, 8    # ppoly.cuh's kPpolyMaxSeg / MaxDeg


def _check_family(ln_base, other_base):
    if ln_base not in ("ivit", "ibert"):
        raise NotImplementedError(
            f"fused block kernels take the ivit or ibert LayerNorm, not "
            f"{ln_base!r}")
    if other_base not in _FAMILIES:
        raise NotImplementedError(
            f"no fused block kernel runs the {other_base!r} family (the JAX "
            "package's engines run it unfused, as the port's do); the kernels "
            "take the ivit, ibert and ppoly families")


def _check_ppoly(bounds, coeffs, name):
    """A fitted table's leaves on the card: bounds int32 [seg-1], coeffs
    f32 [seg, deg+1], within the kernels' segment and degree limits."""
    if not isinstance(coeffs, torch.Tensor) or coeffs.dim() != 2:
        raise ValueError(f"{name}_coeffs: want a [seg, deg + 1] tensor, got "
                         f"{_describe(coeffs)}")
    seg, deg = coeffs.shape[0], coeffs.shape[1] - 1
    if not (1 <= seg <= PPOLY_MAX_SEG and 0 <= deg <= PPOLY_MAX_DEG):
        raise ValueError(
            f"{name}: the kernels take 1-{PPOLY_MAX_SEG} segments of degree "
            f"0-{PPOLY_MAX_DEG}; got {seg} segments of degree {deg}")
    _check(coeffs, f"{name}_coeffs", torch.float32, (seg, deg + 1))
    if seg > 1:
        _check(bounds, f"{name}_bounds", torch.int32, (seg - 1,))
    return seg, deg


# ---------------------------------------------------------------------------
# The freeze-time table forms (block.py _softmax_lut, _shift_gelu_lut,
# _ibert_gelu_lut, _ppoly_gelu_lut)
# ---------------------------------------------------------------------------

INT32_MAX = 2.0**31 - 1     # 2**31 once in f32, as the reference rounds it
LUT_SIZE = 256


def _lut_on() -> bool:
    """The kernels' table forms: on where ``IVIT_LUT`` is set to anything
    but 0 (``block.py:347``), read at each call; off by default."""
    return os.environ.get("IVIT_LUT", "0") not in ("", "0")


def _take(lut, idx):
    """``lut[idx]`` for f32-held indices in the table."""
    return lut.reshape(-1)[idx.long()]


def softmax_lut(s, lut, sm_base, sm_bit, n_valid=None, sum_i32=False,
                sat=None, sat_mask=None):
    """The table softmax of f32 integer scores over the last axis (the
    first ``n_valid`` columns real; None: all): exp = ``lut[clip(max - x,
    0, 255)]``, ``sat`` where ``sat_mask`` holds (Swin's negative shift
    mask), 0 past ``n_valid``; then ivit: the row sum as one int32
    reduction (``sum_i32``) or two limbs clamped to INT32_MAX, the 2**31
    reciprocal; ibert: an int32 sum, the 2**32 reciprocal; ppoly: an f32
    sum clamped at 1, the 2**32 reciprocal.  ``sm_bit`` probabilities,
    f32-held (``block.py:403``, ``vit_int.py:270``)."""
    x = s
    mask = None
    if n_valid is not None and n_valid != s.shape[-1]:
        mask = torch.arange(s.shape[-1], device=s.device) < n_valid
        x = torch.where(mask, s, torch.full_like(s, -(2.0**23)))
    x_max = torch.amax(x, dim=-1, keepdim=True)
    exp = _take(lut, torch.clamp(x_max - x, 0.0, lut.numel() - 1.0))
    if sat is not None:
        exp = torch.where(sat_mask, sat.reshape(()).to(exp.dtype), exp)
    if mask is not None:
        exp = torch.where(mask, exp, torch.zeros_like(exp))
    if sm_base == "ppoly":
        exp_sum = torch.clamp(exp.sum(-1, keepdim=True), min=1.0)
        factor = torch.floor(rdiv(2.0**32, exp_sum))
        return torch.floor(exp * factor * 2.0 ** -(32 - sm_bit + 1))
    if sm_base == "ibert" or sum_i32:
        exp_sum = exp.to(torch.int32).sum(-1, keepdim=True,
                                          dtype=torch.int32).float()
    else:
        exp_sum = torch.clamp(exact_int_sum(exp), max=INT32_MAX)
    if sm_base == "ibert":
        factor = torch.floor(rdiv(2.0**32, exp_sum))
        return torch.floor(exp * factor * 2.0 ** -(32 - sm_bit + 1))
    factor = torch.floor(rdiv(INT32_MAX, exp_sum))
    return torch.floor(exp * factor * 2.0 ** -(31 - sm_bit + 1))


def gelu_lut_int(h, lut, gelu_base, s_gelu=None, fast_q=False):
    """The table GELU of the f32 int8 fc1 requant ``h`` [..., hidden], before
    its requant: ivit, ShiftGELU with its exps ``lut[max - x]`` and the
    row's ``exp(-max)`` tower, the reference's sigmoid chain after them;
    ibert, ``x * lut[x + 128]``; ppoly, ``lut[x + 128]`` (``block.py:449-484``,
    ``vit_int.py:365``)."""
    if gelu_base == "ivit":
        x_max = torch.amax(h, dim=-1, keepdim=True)
        exp = _take(lut, torch.clamp(x_max - h, 0.0, lut.numel() - 1.0))
        exp_max, _ = iv.int_exp_shift(-x_max, s_gelu * 1.702, 23, fast_q=fast_q)
        factor = torch.floor(rdiv(INT32_MAX, torch.clamp(exp + exp_max,
                                                         max=INT32_MAX)))
        return h * torch.floor(exp * factor * 2.0 ** -(31 - 8 + 1))
    u = _take(lut, torch.clamp(h + 128.0, 0.0, lut.numel() - 1.0))
    return h * u if gelu_base == "ibert" else u


# ---------------------------------------------------------------------------
# MLP half-block
# ---------------------------------------------------------------------------

def mlp_block_ref(x, *, ln_bias, m_ln, ln_shift, fc1_w, fc1_b, m_fc1, s_gelu,
                  m_gelu, fc2_w, fc2_b, m_fc2, m_res_x, m_res_id, mlp_bits=8,
                  out_bits=8, fast_exp=False, fast_poly=False, ln_base="ibert",
                  gelu_base="ibert", ln_in=None, gelu_bounds=None,
                  gelu_coeffs=None, gelu_s_out=None, gelu_scale_bits=22,
                  gelu_fastdiv=False, gelu_s_out_c=None, gelu_patch_h=None,
                  gelu_patch_d=None, gelu_lut=None, use_int_sqrt=False):
    """Plain version of the MLP kernel: x int8 or int16 [R, C] -> [R, C] in
    the ``out_bits`` container (ViT: int8 -> int8; Swin: int16 -> int16 with
    ``mlp_bits`` 8 and ``out_bits`` 16).

    LN (or ``ln_in``) -> requant -> fc1 + bias -> requant -> GELU (ShiftGELU
    over the whole hidden row, the ibert GELU, or the ppoly GELU of the
    fitted ``gelu_bounds`` / ``gelu_coeffs`` onto its ``gelu_s_out`` grid,
    by ``rdiv`` or, with ``gelu_fastdiv``, by the freeze gate's multiply
    and patches; with ``gelu_lut``, :func:`gelu_lut_int`) -> requant ->
    fc2 + bias -> requant to ``mlp_bits`` -> integer residual."""
    y = _ln8(x, ln_base, ln_bias, ln_shift, m_ln, ln_in, use_int_sqrt)
    h = _requant(int8_matmul(y, fc1_w) + fc1_b, m_fc1, 8)
    if gelu_lut is not None:
        g = gelu_lut_int(h, gelu_lut, gelu_base, s_gelu, fast_exp)
    elif gelu_base == "ivit":
        g, _ = iv.shift_gelu_int(h, s_gelu, 8, fast_q=fast_exp)
    elif gelu_base == "ppoly":
        g = pp.ppoly_gelu_int(h, gelu_bounds, gelu_coeffs, gelu_scale_bits,
                              gelu_s_out, gelu_fastdiv, gelu_s_out_c,
                              gelu_patch_h, gelu_patch_d)
    else:
        g, _ = ib.ibert_gelu_int(h, s_gelu, fast_poly)
    g = _requant(g, m_gelu, 8).to(torch.int8)
    y2 = _requant(int8_matmul(g, fc2_w) + fc2_b, m_fc2, mlp_bits)
    return _residual(y2, m_res_x, x, m_res_id, out_bits)


_KIND = {"ibert": 0, "ivit": 1, "ppoly": 2}   # the kernels' family codes


def _ln_kind(ln_base, use_int_sqrt):
    """The kernels' LayerNorm code: 0 the ibert LN (floor(sqrt)), 1
    I-LayerNorm, 2 the ibert LN with I-BERT's integer sqrt."""
    if ln_base == "ivit":
        return 1
    return 2 if use_int_sqrt else 0
PPOLY_MAX_PATCHES = 8                   # the fast-div gate's patch slots


class _PpolyArgs(ctypes.Structure):
    """``ppoly.cuh`` ``PpolyArgs``: a fitted table's device leaves and
    its epilogue's constants, handed to the C entry points by address."""
    _fields_ = [("bounds", ctypes.c_void_p), ("coeffs", ctypes.c_void_p),
                ("s_out", ctypes.c_void_p), ("s_out_c", ctypes.c_void_p),
                ("patch_h", ctypes.c_void_p), ("patch_d", ctypes.c_void_p),
                ("seg", ctypes.c_int), ("deg", ctypes.c_int),
                ("scale_bits", ctypes.c_int), ("fastdiv", ctypes.c_int),
                ("npatch", ctypes.c_int), ("exp_bits", ctypes.c_int)]


def _softmax_tables(sm_base, bounds, coeffs, exp_bits, sm_lut, device):
    """The attention core's exp table: the spec's ``sm_lut`` (checked, 256
    f32 on the card; the ppoly core then reads it in place of its own), or
    the ppoly softmax's C arguments and its table's scratch (256 f32,
    built by a launch before the core); (None, None) for the ivit and
    ibert towers."""
    if sm_lut is not None:
        _check(sm_lut, "sm_lut", torch.float32, (LUT_SIZE,))
    if sm_base != "ppoly":
        return None, sm_lut
    seg, deg = _check_ppoly(bounds, coeffs, "sm")
    if not 1 <= exp_bits <= 30:
        raise ValueError(f"exp_bits={exp_bits}: the kernels take 1-30")
    args = _PpolyArgs(_ptr(bounds if seg > 1 else None), _ptr(coeffs), None,
                      None, None, None, seg, deg, 0, 0, 0, int(exp_bits))
    if sm_lut is not None:
        return args, sm_lut
    return args, torch.empty(256, dtype=torch.float32, device=device)


def _lut_mode(sm_lut, sm_sum_i32):
    """The cores' table code: 0 the towers, 1 the spec's table with the
    two-limb ivit row sum, 2 with the one int32 reduction."""
    return 0 if sm_lut is None else (2 if sm_sum_i32 else 1)


def _pp_ref(args):
    return ctypes.c_void_p(None) if args is None else ctypes.byref(args)


_STREAM = (torch.int8, torch.int16)    # the token streams the kernels take
_MAX_SMEM = 232448                     # a block's shared memory on sm_90
GELU_TABLE_BYTES = 256 * 256           # ShiftGELU's [row max][value] outputs


def _check(t, name, dtype, shape, align=16):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda" \
            or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(
            f"{name}: want a contiguous {align}-byte-aligned cuda {dtype} "
            f"tensor of shape {shape}, got {_describe(t)}")


def _check_scalar(t, name):
    """A scalar operand: one f32 on the card, which the kernel reads and
    derives its constants from (the spec's 0-d leaves)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda" \
            or t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{name}: want a one-element cuda float32 tensor, "
                         f"got {_describe(t)}")


def _describe(t):
    if isinstance(t, torch.Tensor):
        return f"{t.dtype} {tuple(t.shape)} on {t.device}"
    return type(t).__name__


def _ptr(t):
    """A tensor's device address; None (an operand left out) is null."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")


def _count(fn, lut, int_sqrt):
    """One launch of ``fn``'s kernel, and of its table form or integer-sqrt
    LN where it ran them."""
    fn.launches += 1
    fn.lut_launches += lut is not None
    fn.int_sqrt_launches += bool(int_sqrt)


@spanned("ivit.kernel.mlp_block")
def mlp_block(x, *, ln_bias, m_ln, ln_shift, fc1_w, fc1_b, m_fc1, s_gelu,
              m_gelu, fc2_w, fc2_b, m_fc2, m_res_x, m_res_id, mlp_bits=8,
              out_bits=8, fast_exp=False, fast_poly=False, ln_base="ibert",
              gelu_base="ibert", use_int_sqrt=False, ln_in=None, fc1_wt=None,
              fc2_wt=None, gelu_bounds=None, gelu_coeffs=None,
              gelu_s_out=None, gelu_scale_bits=22, gelu_fastdiv=False,
              gelu_s_out_c=None, gelu_patch_h=None, gelu_patch_d=None,
              gelu_lut=None):
    """Fused MLP half-block; ``x`` int8 or int16 [R, C] token rows, out in
    the ``out_bits`` container, int8 or int16 (int8 -> int8 for ViT, int16
    -> int16 for Swin, int16 -> int8 for the INT16 configuration's ViT:
    ``norm2_in`` 16, ``att_block_out`` 8); ``ln_in``: the hoisted int8 LN output of
    ``x``, or None to run the LN in the kernel.  ``fc1_wt`` / ``fc2_wt``:
    ``fc1_w`` / ``fc2_w`` transposed to torch's Linear layout [out, in] and
    contiguous, which the kernel streams, or None to transpose them here;
    the plain version does not read them.  ``gelu_*``: the ppoly GELU's
    spec leaves (``gelu_base="ppoly"``), as JAX's ``mlp_block_p`` takes
    them; on the card its 256 outputs (GELU + requant of every int8 input)
    are one table launch, looked up in fc1's epilogue.  ``gelu_lut``: the
    spec's GELU table, used where ``IVIT_LUT`` is set (the tower otherwise);
    on the card the ivit table launch takes its exps from it, and the ibert
    and ppoly GELUs + requant of all 256 inputs are one table launch from
    it, looked up in fc1's epilogue."""
    _check_family(ln_base, gelu_base)
    gelu_lut = gelu_lut if gelu_lut is not None and _lut_on() else None
    kw = dict(ln_bias=ln_bias, m_ln=m_ln, ln_shift=ln_shift, fc1_w=fc1_w,
              fc1_b=fc1_b, m_fc1=m_fc1, s_gelu=s_gelu, m_gelu=m_gelu,
              fc2_w=fc2_w, fc2_b=fc2_b, m_fc2=m_fc2, m_res_x=m_res_x,
              m_res_id=m_res_id, mlp_bits=mlp_bits, out_bits=out_bits,
              fast_exp=fast_exp, fast_poly=fast_poly, ln_base=ln_base,
              gelu_base=gelu_base, ln_in=ln_in, gelu_bounds=gelu_bounds,
              gelu_coeffs=gelu_coeffs, gelu_s_out=gelu_s_out,
              gelu_scale_bits=gelu_scale_bits, gelu_fastdiv=gelu_fastdiv,
              gelu_s_out_c=gelu_s_out_c, gelu_patch_h=gelu_patch_h,
              gelu_patch_d=gelu_patch_d, gelu_lut=gelu_lut,
              use_int_sqrt=use_int_sqrt)
    if x.device.type == "cpu":
        return mlp_block_ref(x, **kw)
    r, c = x.shape
    hd = fc1_w.shape[1]
    out_dtype = container(out_bits)
    # the 64-row wgmma block takes the shapes whose tiles fit its shared
    # memory, the 32-row block (this formula, mlp_smem) every other
    smem = 32 * (c + hd + 32) + 2 * _pass_width(c, hd) * 80
    if (c % 32 or c > 1024 or not _pass_width(c, hd) or smem > _MAX_SMEM
            or x.dtype not in _STREAM or out_dtype not in _STREAM
            or not 2 <= mlp_bits <= 16 or out_bits < 2):
        raise ValueError(
            f"mlp_block kernel takes C a multiple of 32 (<= 1024) sharing a "
            f"128-, 96- or 64-column pass with the hidden width, an int8 or "
            f"int16 stream in and out (mlp_bits and out_bits 2-16); got "
            f"C={c}, hidden={hd}, x {x.dtype}, bits={mlp_bits}/{out_bits}")
    for name, t, dt, shp in (
            ("x", x, x.dtype, (r, c)), ("ln_bias", ln_bias, torch.float32, (c,)),
            ("m_ln", m_ln, torch.float32, (c,)),
            ("fc1_w", fc1_w, torch.int8, (c, hd)), ("fc1_b", fc1_b, torch.int32, (hd,)),
            ("m_fc1", m_fc1, torch.float32, (hd,)),
            ("fc2_w", fc2_w, torch.int8, (hd, c)), ("fc2_b", fc2_b, torch.int32, (c,)),
            ("m_fc2", m_fc2, torch.float32, (c,))):
        _check(t, name, dt, shp)
    if ln_in is not None:
        _check(ln_in, "ln_in", torch.int8, (r, c))
    # the kernel streams weight rows of torch's Linear layout [out, in]
    if fc1_wt is None:
        fc1_wt = fc1_w.t().contiguous()
        mlp_block.transposes += 1
    if fc2_wt is None:
        fc2_wt = fc2_w.t().contiguous()
        mlp_block.transposes += 1
    _check(fc1_wt, "fc1_wt", torch.int8, (hd, c))
    _check(fc2_wt, "fc2_wt", torch.int8, (c, hd))
    for name, t in (("ln_shift", ln_shift), ("s_gelu", s_gelu),
                    ("m_gelu", m_gelu), ("m_res_x", m_res_x),
                    ("m_res_id", m_res_id)):
        _check_scalar(t, name)
    if gelu_lut is not None:
        _check(gelu_lut, "gelu_lut", torch.float32, (LUT_SIZE,))
    pp_args = None
    if gelu_base == "ppoly" and gelu_lut is None:
        seg, deg = _check_ppoly(gelu_bounds, gelu_coeffs, "gelu")
        _check_scalar(gelu_s_out, "gelu_s_out")
        npatch = 0
        if gelu_fastdiv:
            _check_scalar(gelu_s_out_c, "gelu_s_out_c")
            npatch = gelu_patch_h.numel() if isinstance(gelu_patch_h, torch.Tensor) else -1
            if not 0 <= npatch <= PPOLY_MAX_PATCHES:
                raise ValueError(f"gelu_patch_h: the kernels take at most "
                                 f"{PPOLY_MAX_PATCHES} fast-div patches, got "
                                 f"{_describe(gelu_patch_h)}")
            _check(gelu_patch_h, "gelu_patch_h", torch.float32, (npatch,))
            _check(gelu_patch_d, "gelu_patch_d", torch.float32, (npatch,))
        pp_args = _PpolyArgs(
            _ptr(gelu_bounds if seg > 1 else None), _ptr(gelu_coeffs),
            _ptr(gelu_s_out), _ptr(gelu_s_out_c if gelu_fastdiv else None),
            _ptr(gelu_patch_h if npatch else None),
            _ptr(gelu_patch_d if npatch else None), seg, deg,
            int(gelu_scale_bits), int(bool(gelu_fastdiv)), npatch, 0)
    out = torch.empty((r, c), dtype=out_dtype, device=x.device)
    table = (torch.empty(GELU_TABLE_BYTES if gelu_base == "ivit" else 256,
                         dtype=torch.int8, device=x.device)
             if gelu_base != "ibert" or gelu_lut is not None else None)
    lib = _build.library("mlp_block")
    err = lib.ivit_mlp_block(
        _ptr(x), _ptr(ln_in), _ptr(ln_bias), _ptr(m_ln), _ptr(ln_shift),
        _ptr(fc1_wt), _ptr(fc1_b), _ptr(m_fc1), _ptr(s_gelu), _ptr(m_gelu),
        _ptr(fc2_wt), _ptr(fc2_b), _ptr(m_fc2), _ptr(m_res_x), _ptr(m_res_id),
        _ptr(out), r, c, hd, mlp_bits, out_bits, int(x.dtype == torch.int16),
        _ln_kind(ln_base, use_int_sqrt), _KIND[gelu_base], int(bool(fast_exp)),
        int(bool(fast_poly)), _ptr(table), _pp_ref(pp_args), _ptr(gelu_lut),
        _stream())
    _raise_on(err, "mlp_block")
    _count(mlp_block, gelu_lut, use_int_sqrt and ln_base == "ibert")
    return out


mlp_block.launches = mlp_block.lut_launches = mlp_block.int_sqrt_launches = 0
mlp_block.transposes = 0


# ---------------------------------------------------------------------------
# Attention half-block
# ---------------------------------------------------------------------------

def attn_block_ref(x, *, ln_bias, m_ln, ln_shift, qkv_w, qkv_b, m_qkv, m_attn,
                   s_attn, m_av, proj_w, proj_b, m_proj, m_res_x, m_res_id,
                   num_heads, n_valid, s_exp_act=None, sm_bit=8, attn_bits=8,
                   proj_bits=8, out_bits=8, fast_exp=False, fast_poly=False,
                   ln_base="ibert", sm_base="ibert", ln_in=None,
                   sm_bounds=None, sm_coeffs=None, exp_bits=16, sm_lut=None,
                   sm_sum_i32=False, use_int_sqrt=False):
    """Plain version of the attention kernel: x int8 or int16 [B, Np, C] ->
    the ``out_bits`` container (int8, or int16 for the INT16
    configuration's ``norm2_in`` 16).

    LN (or ``ln_in``) -> requant -> qkv GEMM -> requant -> per head int32
    q k^T -> requant by ``m_attn`` -> softmax over the ``n_valid`` columns
    to ``sm_bit`` probabilities (Shiftmax, the ibert softmax with its 16-bit
    exp requant by ``s_exp_act``, or the ppoly softmax of ``sm_bounds`` /
    ``sm_coeffs`` on the ``exp_bits`` grid; with ``sm_lut``,
    :func:`softmax_lut`) -> probs @ v -> requant by ``m_av`` -> proj GEMM
    -> requant -> residual."""
    b, np_, c = x.shape
    dh = c // num_heads
    y = _ln8(x, ln_base, ln_bias, ln_shift, m_ln, ln_in, use_int_sqrt)
    qkv = _requant(int8_matmul(y, qkv_w) + qkv_b, m_qkv, 8).to(torch.int8)
    qkv = qkv.reshape(b, np_, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                         # [B, H, Np, Dh]
    scores = int8_matmul(q, k.transpose(-1, -2))             # [B, H, Np, Np]
    s = _requant(scores, m_attn, attn_bits)
    if sm_lut is not None:
        probs = softmax_lut(s, sm_lut, sm_base, sm_bit, n_valid, sm_sum_i32)
    else:
        probs = _softmax_probs(s, sm_base, s_attn, s_exp_act, sm_bit, n_valid,
                               fast_exp, fast_poly, sm_bounds, sm_coeffs,
                               exp_bits)
    ctx = _requant(int8_matmul(to_container(probs, sm_bit), v), m_av, 8)
    ctx = ctx.to(torch.int8).permute(0, 2, 1, 3).reshape(b, np_, c)
    y2 = _requant(int8_matmul(ctx, proj_w) + proj_b, m_proj, proj_bits)
    return _residual(y2, m_res_x, x, m_res_id, out_bits)


def _softmax_probs(s, sm_base, s_attn, s_exp_act, sm_bit, n_valid, fast_exp,
                   fast_poly, sm_bounds=None, sm_coeffs=None, exp_bits=16):
    """f32 integer scores -> ``sm_bit`` probabilities over the last axis,
    the first ``n_valid`` columns real (None: all): Shiftmax, the ibert
    softmax with its 16-bit exp requant by ``s_exp_act``, or the ppoly
    softmax."""
    if sm_base == "ppoly":
        return pp.ppoly_softmax_int(s, sm_bounds, sm_coeffs, exp_bits, sm_bit,
                                    n_valid)
    if sm_base == "ivit":
        probs, _ = iv.shiftmax_int(s, s_attn, sm_bit, n_valid=n_valid,
                                   fast_q=fast_exp)
        return probs
    exp_int, _ = ib.ibert_softmax_exp_int(s, s_attn, n_valid, fast_q=fast_exp,
                                          fast_poly=fast_poly)
    exp16 = torch.clamp(torch.round(exp_int * rdiv(1.0, s_exp_act)),
                        -(2.0**15), 2.0**15 - 1)
    factor = torch.floor(rdiv(2.0**32, exact_int_sum(exp16)))
    return torch.floor(exp16 * factor / 2 ** (32 - sm_bit + 1))


@spanned("ivit.kernel.attn_block")
def attn_block(x, *, ln_bias, m_ln, ln_shift, qkv_w, qkv_b, m_qkv, m_attn,
               s_attn, m_av, proj_w, proj_b, m_proj, m_res_x, m_res_id,
               num_heads, n_valid, s_exp_act=None, sm_bit=8, attn_bits=8,
               proj_bits=8, out_bits=8, fast_exp=False, fast_poly=False,
               ln_base="ibert", sm_base="ibert", use_int_sqrt=False,
               ln_in=None, sm_bounds=None, sm_coeffs=None, exp_bits=16,
               sm_lut=None, sm_sum_i32=False):
    """Fused attention half-block; ``x`` int8 or int16 [B, Np, C],
    ``n_valid`` real tokens per image, out in the ``out_bits`` container
    (int8 or int16); ``sm_bit`` 8 or 16: the probabilities' bits (16: the
    INT16 configuration; P v takes them exactly as two 8-bit products);
    ``ln_in``: the hoisted int8 LN output of ``x``, or None to run the LN
    in the kernel; ``s_exp_act``: the ibert softmax's exp scale (unused by
    the others); ``sm_bounds``, ``sm_coeffs``, ``exp_bits``: the ppoly
    softmax's leaves; ``sm_lut``: the spec's exp table, used where
    ``IVIT_LUT`` is set (the tower otherwise), with ``sm_sum_i32`` the ivit
    row sum as one int32 reduction.  On the card: three launches (LN + qkv,
    per-(image, head) softmax attention, proj + residual), after the ppoly
    exp table's (none with ``sm_lut``), counted as one."""
    _check_family(ln_base, sm_base)
    sm_lut = sm_lut if sm_lut is not None and _lut_on() else None
    kw = dict(ln_bias=ln_bias, m_ln=m_ln, ln_shift=ln_shift, qkv_w=qkv_w,
              qkv_b=qkv_b, m_qkv=m_qkv, m_attn=m_attn, s_attn=s_attn,
              s_exp_act=s_exp_act, m_av=m_av, proj_w=proj_w, proj_b=proj_b,
              m_proj=m_proj, m_res_x=m_res_x, m_res_id=m_res_id,
              num_heads=num_heads, n_valid=n_valid, sm_bit=sm_bit,
              attn_bits=attn_bits, proj_bits=proj_bits, out_bits=out_bits,
              fast_exp=fast_exp, fast_poly=fast_poly, ln_base=ln_base,
              sm_base=sm_base, ln_in=ln_in, sm_bounds=sm_bounds,
              sm_coeffs=sm_coeffs, exp_bits=exp_bits, sm_lut=sm_lut,
              sm_sum_i32=sm_sum_i32, use_int_sqrt=use_int_sqrt)
    if x.device.type == "cpu":
        return attn_block_ref(x, **kw)
    b, np_, c = x.shape
    dh = c // num_heads
    if (c % 32 or c > 1024 or not _pass_width(3 * c, c)
            or dh * num_heads != c or dh % 4 or dh > 128
            or np_ > 256 or not 0 < n_valid <= np_ or sm_bit not in (8, 16)
            or not 2 <= attn_bits <= 8 or not 2 <= proj_bits <= 16
            or not 2 <= out_bits <= 16 or x.dtype not in _STREAM):
        raise ValueError(
            f"attn_block kernel takes an int8 or int16 stream, C a multiple "
            f"of 32 (<= 1024) with a 128-, 96- or 64-column pass over 3C and "
            f"C, head dim a multiple of 4 (<= 128), <= 256 tokens, 8- or "
            f"16-bit probs, 8-bit scores and outputs of up to 16 bits; got "
            f"{x.dtype} C={c}, heads={num_heads}, Np={np_}, n_valid={n_valid}, "
            f"sm_bit={sm_bit}, bits={attn_bits}/{proj_bits}/{out_bits}")
    for name, t, dt, shp in (
            ("x", x, x.dtype, (b, np_, c)),
            ("ln_bias", ln_bias, torch.float32, (c,)),
            ("m_ln", m_ln, torch.float32, (c,)),
            ("qkv_w", qkv_w, torch.int8, (c, 3 * c)),
            ("qkv_b", qkv_b, torch.int32, (3 * c,)),
            ("m_qkv", m_qkv, torch.float32, (3 * c,)),
            ("proj_w", proj_w, torch.int8, (c, c)),
            ("proj_b", proj_b, torch.int32, (c,)),
            ("m_proj", m_proj, torch.float32, (c,))):
        _check(t, name, dt, shp)
    if ln_in is not None:
        _check(ln_in, "ln_in", torch.int8, (b, np_, c))
    scalars = [("ln_shift", ln_shift), ("m_attn", m_attn), ("s_attn", s_attn),
               ("m_av", m_av), ("m_res_x", m_res_x), ("m_res_id", m_res_id)]
    if sm_base == "ibert":
        scalars.append(("s_exp_act", s_exp_act))
    for name, t in scalars:
        _check_scalar(t, name)
    pp_args, exp_table = _softmax_tables(sm_base, sm_bounds, sm_coeffs,
                                         exp_bits, sm_lut, x.device)
    qkv = torch.empty((b * np_, 3 * c), dtype=torch.int8, device=x.device)
    ctx = torch.empty((b * np_, c), dtype=torch.int8, device=x.device)
    out = torch.empty((b, np_, c), dtype=container(out_bits), device=x.device)
    lib = _build.library("attn_block")
    wqkv_t, wp_t = qkv_w.t().contiguous(), proj_w.t().contiguous()
    attn_block.transposes += 2
    err = lib.ivit_attn_block(
        _ptr(x), _ptr(ln_in), _ptr(ln_bias), _ptr(m_ln), _ptr(ln_shift),
        _ptr(wqkv_t), _ptr(qkv_b), _ptr(m_qkv), _ptr(m_attn), _ptr(s_attn),
        _ptr(s_exp_act), _ptr(m_av), _ptr(wp_t), _ptr(proj_b), _ptr(m_proj),
        _ptr(m_res_x), _ptr(m_res_id), _ptr(qkv), _ptr(ctx), _ptr(out), b,
        np_, c, num_heads, n_valid, sm_bit, attn_bits, proj_bits, out_bits,
        int(x.dtype == torch.int16), _ln_kind(ln_base, use_int_sqrt),
        _KIND[sm_base], int(bool(fast_exp)), int(bool(fast_poly)),
        _pp_ref(pp_args), _ptr(exp_table), _lut_mode(sm_lut, sm_sum_i32),
        _stream())
    _raise_on(err, "attn_block")
    _count(attn_block, sm_lut, use_int_sqrt and ln_base == "ibert")
    return out


attn_block.launches = attn_block.lut_launches = attn_block.int_sqrt_launches = 0
attn_block.transposes = 0


# ---------------------------------------------------------------------------
# Swin window-attention half-block
# ---------------------------------------------------------------------------

def swin_attn_block_ref(xw, *, ln_bias, m_ln, ln_shift, qkv_w, qkv_b, m_qkv,
                        m_attn, m_attn2, s_attn, rel_addend, mask_addend, m_av,
                        proj_w, proj_b, m_proj, m_res_x, m_res_id, num_heads,
                        n_windows, s_exp_act=None, sm_bit=8, fast_exp=False,
                        fast_poly=False, ln_base="ivit", sm_base="ivit",
                        ln_in=None, sm_bounds=None, sm_coeffs=None,
                        exp_bits=16, sm_lut=None, sm_sum_i32=False,
                        sm_sat=None, use_int_sqrt=False):
    """Plain version of the Swin window-attention kernel: xw int8 or int16
    [B*nW, n, C] (rolled and window-partitioned) -> int16 [B*nW, n, C].

    LN (or ``ln_in``) -> requant -> qkv GEMM -> requant -> per (window,
    head) int32 q k^T -> ``clip(round(clip(round(s * m_attn)) * m_attn2) +
    rel_addend)`` to int8 -> + the window's ``mask_addend`` [nW, n, n] on
    shifted blocks (after the clip, so masked scores leave the int8 range)
    -> softmax over the n keys (with ``sm_lut``, :func:`softmax_lut`, which
    takes ``sm_sat`` where the mask is negative) -> probs @ v -> requant by
    ``m_av`` -> proj GEMM -> requant to 16 bits -> integer residual to
    int16 (``block.py::_swin_attn_kernel``)."""
    bw, n, c = xw.shape
    dh = c // num_heads
    y = _ln8(xw, ln_base, ln_bias, ln_shift, m_ln, ln_in, use_int_sqrt)
    qkv = _requant(int8_matmul(y, qkv_w) + qkv_b, m_qkv, 8).to(torch.int8)
    qkv = qkv.reshape(bw, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                         # [BW, H, n, Dh]
    s = _requant(int8_matmul(q, k.transpose(-1, -2)), m_attn, 8)
    a = torch.clamp(torch.round(s * m_attn2) + rel_addend, -128, 127)
    sat_mask = None
    if mask_addend is not None:
        a = a.reshape(-1, n_windows, num_heads, n, n) + mask_addend[None, :, None]
        a = a.reshape(bw, num_heads, n, n)
        sat_mask = (mask_addend < 0)[None, :, None].expand(
            bw // n_windows, -1, num_heads, -1, -1).reshape(bw, num_heads, n, n)
    if sm_lut is not None:
        probs = softmax_lut(a, sm_lut, sm_base, sm_bit, None, sm_sum_i32,
                            sm_sat, sat_mask if sm_sat is not None else None)
    else:
        probs = _softmax_probs(a, sm_base, s_attn, s_exp_act, sm_bit, None,
                               fast_exp, fast_poly, sm_bounds, sm_coeffs,
                               exp_bits)
    ctx = _requant(int8_matmul(to_container(probs, sm_bit), v), m_av, 8)
    ctx = ctx.to(torch.int8).permute(0, 2, 1, 3).reshape(bw, n, c)
    y2 = _requant(int8_matmul(ctx, proj_w) + proj_b, m_proj, 16)
    return _residual(y2, m_res_x, xw, m_res_id, 16)


@spanned("ivit.kernel.swin_attn_block")
def swin_attn_block(xw, *, ln_bias, m_ln, ln_shift, qkv_w, qkv_b, m_qkv,
                    m_attn, m_attn2, s_attn, rel_addend, mask_addend, m_av,
                    proj_w, proj_b, m_proj, m_res_x, m_res_id, num_heads,
                    n_windows, s_exp_act=None, sm_bit=8, fast_exp=False,
                    fast_poly=False, ln_base="ivit", sm_base="ivit",
                    use_int_sqrt=False, ln_in=None, sm_bounds=None,
                    sm_coeffs=None, exp_bits=16, sm_lut=None, sm_sum_i32=False,
                    sm_sat=None):
    """Fused Swin window-attention half-block; ``xw`` int8 or int16
    [B*nW, n, C], windows of ``n`` tokens, ``n_windows`` windows an image;
    ``rel_addend`` f32 [H, n, n]; ``mask_addend`` f32 [nW, n, n] for a
    shifted block, else None; ``ln_in``: the hoisted int8 LN output of
    ``xw``, or None to run the LN in the kernel; ``sm_bounds``,
    ``sm_coeffs``, ``exp_bits``: the ppoly softmax's leaves; ``sm_lut``,
    ``sm_sum_i32``: as ``attn_block``'s, used where ``IVIT_LUT`` is set and,
    on a shifted block, ``sm_sat`` (the exp of a masked score) is given
    (``block.py:1486``).  Returns int16 [B*nW, n, C].  On the card: three
    launches (LN + qkv, per-(window, head) softmax attention, proj +
    residual), after the ppoly exp table's (none with ``sm_lut``), counted
    as one."""
    _check_family(ln_base, sm_base)
    use = (sm_lut is not None and _lut_on()
           and (mask_addend is None or sm_sat is not None))
    sm_lut = sm_lut if use else None
    sm_sat = sm_sat if use and mask_addend is not None else None
    if sm_sat is not None and sm_base == "ppoly":
        raise ValueError("sm_sat: the ppoly softmax never saturates "
                         "(luts.swin_shift_sat), so no shifted ppoly block "
                         "takes a table")
    kw = dict(ln_bias=ln_bias, m_ln=m_ln, ln_shift=ln_shift, qkv_w=qkv_w,
              qkv_b=qkv_b, m_qkv=m_qkv, m_attn=m_attn, m_attn2=m_attn2,
              s_attn=s_attn, rel_addend=rel_addend, mask_addend=mask_addend,
              m_av=m_av, proj_w=proj_w, proj_b=proj_b, m_proj=m_proj,
              m_res_x=m_res_x, m_res_id=m_res_id, num_heads=num_heads,
              n_windows=n_windows, s_exp_act=s_exp_act, sm_bit=sm_bit,
              fast_exp=fast_exp, fast_poly=fast_poly, ln_base=ln_base,
              sm_base=sm_base, ln_in=ln_in, sm_bounds=sm_bounds,
              sm_coeffs=sm_coeffs, exp_bits=exp_bits, sm_lut=sm_lut,
              sm_sum_i32=sm_sum_i32, sm_sat=sm_sat, use_int_sqrt=use_int_sqrt)
    if xw.device.type == "cpu":
        return swin_attn_block_ref(xw, **kw)
    bw, n, c = xw.shape
    dh = c // num_heads
    if (c % 32 or c > 1024 or not _pass_width(3 * c, c)
            or dh * num_heads != c or dh % 4 or dh > 128 or not 0 < n <= 64
            or sm_bit != 8 or xw.dtype not in _STREAM or n_windows < 1
            or (mask_addend is not None and bw % n_windows)):
        raise ValueError(
            f"swin_attn_block kernel takes an int8 or int16 stream, C a "
            f"multiple of 32 (<= 1024) with a 128-, 96- or 64-column pass "
            f"over 3C and C, head dim a multiple of 4 (<= 128), <= 64 tokens "
            f"a window, whole images of windows and 8-bit probs; got "
            f"{xw.dtype} [{bw}, {n}, {c}], heads={num_heads}, "
            f"n_windows={n_windows}, sm_bit={sm_bit}")
    for name, t, dt, shp in (
            ("xw", xw, xw.dtype, (bw, n, c)),
            ("ln_bias", ln_bias, torch.float32, (c,)),
            ("m_ln", m_ln, torch.float32, (c,)),
            ("qkv_w", qkv_w, torch.int8, (c, 3 * c)),
            ("qkv_b", qkv_b, torch.int32, (3 * c,)),
            ("m_qkv", m_qkv, torch.float32, (3 * c,)),
            ("rel_addend", rel_addend, torch.float32, (num_heads, n, n)),
            ("proj_w", proj_w, torch.int8, (c, c)),
            ("proj_b", proj_b, torch.int32, (c,)),
            ("m_proj", m_proj, torch.float32, (c,))):
        _check(t, name, dt, shp)
    if mask_addend is not None:
        _check(mask_addend, "mask_addend", torch.float32, (n_windows, n, n))
    if ln_in is not None:
        _check(ln_in, "ln_in", torch.int8, (bw, n, c))
    scalars = [("ln_shift", ln_shift), ("m_attn", m_attn), ("m_attn2", m_attn2),
               ("s_attn", s_attn), ("m_av", m_av), ("m_res_x", m_res_x),
               ("m_res_id", m_res_id)]
    if sm_base == "ibert":
        scalars.append(("s_exp_act", s_exp_act))
    if sm_sat is not None:
        scalars.append(("sm_sat", sm_sat))
    for name, t in scalars:
        _check_scalar(t, name)
    pp_args, exp_table = _softmax_tables(sm_base, sm_bounds, sm_coeffs,
                                         exp_bits, sm_lut, xw.device)
    qkv = torch.empty((bw * n, 3 * c), dtype=torch.int8, device=xw.device)
    ctx = torch.empty((bw * n, c), dtype=torch.int8, device=xw.device)
    out = torch.empty((bw, n, c), dtype=torch.int16, device=xw.device)
    lib = _build.library("swin_attn_block")
    wqkv_t, wp_t = qkv_w.t().contiguous(), proj_w.t().contiguous()
    swin_attn_block.transposes += 2
    err = lib.ivit_swin_attn_block(
        _ptr(xw), _ptr(ln_in), _ptr(ln_bias), _ptr(m_ln), _ptr(ln_shift),
        _ptr(wqkv_t), _ptr(qkv_b), _ptr(m_qkv), _ptr(m_attn), _ptr(m_attn2),
        _ptr(rel_addend), _ptr(mask_addend), _ptr(s_attn), _ptr(s_exp_act),
        _ptr(m_av), _ptr(wp_t), _ptr(proj_b), _ptr(m_proj), _ptr(m_res_x),
        _ptr(m_res_id), _ptr(qkv), _ptr(ctx), _ptr(out), bw, n, c, num_heads,
        n_windows, int(xw.dtype == torch.int16), _ln_kind(ln_base, use_int_sqrt),
        _KIND[sm_base], int(bool(fast_exp)), int(bool(fast_poly)),
        _pp_ref(pp_args), _ptr(exp_table), _lut_mode(sm_lut, sm_sum_i32),
        _ptr(sm_sat), _stream())
    _raise_on(err, "swin_attn_block")
    _count(swin_attn_block, sm_lut, use_int_sqrt and ln_base == "ibert")
    return out


swin_attn_block.launches = swin_attn_block.transposes = 0
swin_attn_block.lut_launches = swin_attn_block.int_sqrt_launches = 0
