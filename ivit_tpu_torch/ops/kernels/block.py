"""The engine's two fused half-block kernels, ibert family, for Hopper.

``mlp_block`` replaces ``ivit_tpu/ops/pallas/block.py::mlp_block_p`` and
``attn_block`` replaces ``attn_block_p``.  Each wrapper launches the
hand-written CUDA kernel (``ivit_tpu_torch/csrc/``) for a tensor on the
card and runs its plain PyTorch version, ``mlp_block_ref`` /
``attn_block_ref``, for a tensor on the CPU.  The plain versions follow the
Pallas kernel bodies (``_mlp_kernel``, ``_attn_kernel``) step for step and
run on either device; on the card they are what the kernels are held
against.

On the card every operand is a tensor there, the scalars (LN shift,
scales, multipliers) one-element f32 tensors as the engine spec holds
them: the kernels derive their constants from those in each thread, so
a call launches nothing but the weight transposes and the kernel.

Each wrapper counts its kernel launches in a plain integer attribute
(``mlp_block.launches``, ``attn_block.launches``), incremented only where
the kernel is launched.

Padding rows (token index >= ``n_valid``) may hold anything: their scores
columns are masked out of the softmax and their LN output, NaN for an
all-zero row, is pinned to 0.  Only valid rows of the output are defined.
"""

from __future__ import annotations

import ctypes

import torch

from .. import ibert as ib
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


def _requant(acc, m, bits):
    """``clip(round(acc * m))`` to a ``bits`` signed range, f32-held."""
    lim = 2.0 ** (bits - 1)
    return torch.clamp(torch.round(acc.float() * m), -lim, lim - 1)


def _residual(y2, m_res_x, x, m_res_id, bits):
    lim = 2.0 ** (bits - 1)
    out = torch.clamp(torch.round(y2 * m_res_x) + torch.round(x.float() * m_res_id),
                      -lim, lim - 1)
    return out.to(container(bits))


def _ibert_ln8(x, ln_bias, ln_shift, m_ln):
    """ibert LayerNorm + bias + int8 requant; NaN rows (zero variance) -> 0."""
    y = ib.ibert_layernorm_int(x.float(), ln_shift) + ln_bias
    y = torch.where(torch.isnan(y), torch.zeros_like(y), y)
    return _requant(y, m_ln, 8).to(torch.int8)


def _check_family(ln_base, other_base, use_int_sqrt):
    if ln_base != "ibert" or other_base != "ibert":
        raise NotImplementedError(
            f"fused block kernels for the {ln_base}/{other_base} families "
            "come with a later slice (ROADMAP Queue 2 items 1-2); this port "
            "runs the ibert family")
    if use_int_sqrt:
        raise NotImplementedError(
            "the fused block kernels take the floor(sqrt) ibert LayerNorm; "
            "run use_int_sqrt configs through the unfused engine")


# ---------------------------------------------------------------------------
# MLP half-block
# ---------------------------------------------------------------------------

def mlp_block_ref(x, *, ln_bias, m_ln, ln_shift, fc1_w, fc1_b, m_fc1, s_gelu,
                  m_gelu, fc2_w, fc2_b, m_fc2, m_res_x, m_res_id, mlp_bits=8,
                  out_bits=8, fast_poly=False, **_):
    """Plain version of the MLP kernel: x int8 [R, C] -> int8 [R, C].

    ibert LN -> requant -> fc1 + bias -> requant -> ibert GELU -> requant
    -> fc2 + bias -> requant to ``mlp_bits`` -> integer residual."""
    y = _ibert_ln8(x, ln_bias, ln_shift, m_ln)
    h = _requant(int8_matmul(y, fc1_w) + fc1_b, m_fc1, 8)
    g, _ = ib.ibert_gelu_int(h, s_gelu, fast_poly)
    g = _requant(g, m_gelu, 8).to(torch.int8)
    y2 = _requant(int8_matmul(g, fc2_w) + fc2_b, m_fc2, mlp_bits)
    return _residual(y2, m_res_x, x, m_res_id, out_bits)


def _check(t, name, dtype, shape):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda" \
            or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: want a contiguous 16-byte-aligned cuda {dtype} tensor "
            f"of shape {shape}, got {_describe(t)}")


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
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")


def mlp_block(x, *, ln_bias, m_ln, ln_shift, fc1_w, fc1_b, m_fc1, s_gelu,
              m_gelu, fc2_w, fc2_b, m_fc2, m_res_x, m_res_id, mlp_bits=8,
              out_bits=8, fast_poly=False, ln_base="ibert", gelu_base="ibert",
              use_int_sqrt=False):
    """Fused MLP half-block; ``x`` int8 [R, C] token rows."""
    _check_family(ln_base, gelu_base, use_int_sqrt)
    kw = dict(ln_bias=ln_bias, m_ln=m_ln, ln_shift=ln_shift, fc1_w=fc1_w,
              fc1_b=fc1_b, m_fc1=m_fc1, s_gelu=s_gelu, m_gelu=m_gelu,
              fc2_w=fc2_w, fc2_b=fc2_b, m_fc2=m_fc2, m_res_x=m_res_x,
              m_res_id=m_res_id, mlp_bits=mlp_bits, out_bits=out_bits,
              fast_poly=fast_poly)
    if x.device.type == "cpu":
        return mlp_block_ref(x, **kw)
    r, c = x.shape
    hd = fc1_w.shape[1]
    if c % 64 or hd % 64 or c > 1024 or max(mlp_bits, out_bits) > 8:
        raise ValueError(f"mlp_block kernel takes C, hidden multiples of 64 "
                         f"with C <= 1024 and 8-bit outputs; got C={c}, "
                         f"hidden={hd}, bits={mlp_bits}/{out_bits}")
    for name, t, dt, shp in (
            ("x", x, torch.int8, (r, c)), ("ln_bias", ln_bias, torch.float32, (c,)),
            ("m_ln", m_ln, torch.float32, (c,)),
            ("fc1_w", fc1_w, torch.int8, (c, hd)), ("fc1_b", fc1_b, torch.int32, (hd,)),
            ("m_fc1", m_fc1, torch.float32, (hd,)),
            ("fc2_w", fc2_w, torch.int8, (hd, c)), ("fc2_b", fc2_b, torch.int32, (c,)),
            ("m_fc2", m_fc2, torch.float32, (c,))):
        _check(t, name, dt, shp)
    for name, t in (("ln_shift", ln_shift), ("s_gelu", s_gelu),
                    ("m_gelu", m_gelu), ("m_res_x", m_res_x),
                    ("m_res_id", m_res_id)):
        _check_scalar(t, name)
    out = torch.empty_like(x)
    lib = _build.library("mlp_block")
    # the kernel streams weight rows of torch's Linear layout [out, in]
    w1t, w2t = fc1_w.t().contiguous(), fc2_w.t().contiguous()
    err = lib.ivit_mlp_block(
        _ptr(x), _ptr(ln_bias), _ptr(m_ln), _ptr(ln_shift), _ptr(w1t),
        _ptr(fc1_b), _ptr(m_fc1), _ptr(s_gelu), _ptr(m_gelu), _ptr(w2t),
        _ptr(fc2_b), _ptr(m_fc2), _ptr(m_res_x), _ptr(m_res_id), _ptr(out),
        r, c, hd, mlp_bits, out_bits, int(bool(fast_poly)), _stream())
    _raise_on(err, "mlp_block")
    mlp_block.launches += 1
    return out


mlp_block.launches = 0


# ---------------------------------------------------------------------------
# Attention half-block
# ---------------------------------------------------------------------------

def attn_block_ref(x, *, ln_bias, m_ln, ln_shift, qkv_w, qkv_b, m_qkv, m_attn,
                   s_attn, s_exp_act, m_av, proj_w, proj_b, m_proj, m_res_x,
                   m_res_id, num_heads, n_valid, sm_bit=8, attn_bits=8,
                   proj_bits=8, out_bits=8, fast_exp=False, fast_poly=False,
                   **_):
    """Plain version of the attention kernel: x int8 [B, Np, C] -> int8.

    ibert LN -> requant -> qkv GEMM -> requant -> per head int32 q k^T ->
    requant by ``m_attn`` -> ibert softmax over the ``n_valid`` columns ->
    probs @ v -> requant by ``m_av`` -> proj GEMM -> requant -> residual."""
    b, np_, c = x.shape
    dh = c // num_heads
    y = _ibert_ln8(x, ln_bias, ln_shift, m_ln)
    qkv = _requant(int8_matmul(y, qkv_w) + qkv_b, m_qkv, 8).to(torch.int8)
    qkv = qkv.reshape(b, np_, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                         # [B, H, Np, Dh]
    scores = int8_matmul(q, k.transpose(-1, -2))             # [B, H, Np, Np]
    s = _requant(scores, m_attn, attn_bits)
    exp_int, _ = ib.ibert_softmax_exp_int(s, s_attn, n_valid, fast_q=fast_exp,
                                          fast_poly=fast_poly)
    exp16 = torch.clamp(torch.round(exp_int * rdiv(1.0, s_exp_act)),
                        -(2.0**15), 2.0**15 - 1)
    factor = torch.floor(rdiv(2.0**32, exact_int_sum(exp16)))
    probs = torch.floor(exp16 * factor / 2 ** (32 - sm_bit + 1)).to(container(sm_bit))
    ctx = _requant(int8_matmul(probs, v), m_av, 8).to(torch.int8)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, np_, c)
    y2 = _requant(int8_matmul(ctx, proj_w) + proj_b, m_proj, proj_bits)
    return _residual(y2, m_res_x, x, m_res_id, out_bits)


def attn_block(x, *, ln_bias, m_ln, ln_shift, qkv_w, qkv_b, m_qkv, m_attn,
               s_attn, s_exp_act, m_av, proj_w, proj_b, m_proj, m_res_x,
               m_res_id, num_heads, n_valid, sm_bit=8, attn_bits=8,
               proj_bits=8, out_bits=8, fast_exp=False, fast_poly=False,
               ln_base="ibert", sm_base="ibert", use_int_sqrt=False):
    """Fused attention half-block; ``x`` int8 [B, Np, C], ``n_valid`` real
    tokens per image.  On the card: three launches (LN + qkv, per-(image,
    head) softmax attention, proj + residual) counted as one."""
    _check_family(ln_base, sm_base, use_int_sqrt)
    kw = dict(ln_bias=ln_bias, m_ln=m_ln, ln_shift=ln_shift, qkv_w=qkv_w,
              qkv_b=qkv_b, m_qkv=m_qkv, m_attn=m_attn, s_attn=s_attn,
              s_exp_act=s_exp_act, m_av=m_av, proj_w=proj_w, proj_b=proj_b,
              m_proj=m_proj, m_res_x=m_res_x, m_res_id=m_res_id,
              num_heads=num_heads, n_valid=n_valid, sm_bit=sm_bit,
              attn_bits=attn_bits, proj_bits=proj_bits, out_bits=out_bits,
              fast_exp=fast_exp, fast_poly=fast_poly)
    if x.device.type == "cpu":
        return attn_block_ref(x, **kw)
    b, np_, c = x.shape
    dh = c // num_heads
    if (c % 64 or c > 1024 or dh * num_heads != c or dh % 4 or dh > 128
            or np_ > 256 or not 0 < n_valid <= np_ or sm_bit != 8
            or max(attn_bits, proj_bits, out_bits) > 8):
        raise ValueError(
            f"attn_block kernel takes C a multiple of 64 (<= 1024), head dim "
            f"a multiple of 4 (<= 128), <= 256 tokens, 8-bit probs and "
            f"outputs; got C={c}, heads={num_heads}, Np={np_}, "
            f"n_valid={n_valid}, sm_bit={sm_bit}")
    for name, t, dt, shp in (
            ("x", x, torch.int8, (b, np_, c)),
            ("ln_bias", ln_bias, torch.float32, (c,)),
            ("m_ln", m_ln, torch.float32, (c,)),
            ("qkv_w", qkv_w, torch.int8, (c, 3 * c)),
            ("qkv_b", qkv_b, torch.int32, (3 * c,)),
            ("m_qkv", m_qkv, torch.float32, (3 * c,)),
            ("proj_w", proj_w, torch.int8, (c, c)),
            ("proj_b", proj_b, torch.int32, (c,)),
            ("m_proj", m_proj, torch.float32, (c,))):
        _check(t, name, dt, shp)
    for name, t in (("ln_shift", ln_shift), ("m_attn", m_attn),
                    ("s_attn", s_attn), ("s_exp_act", s_exp_act),
                    ("m_av", m_av), ("m_res_x", m_res_x),
                    ("m_res_id", m_res_id)):
        _check_scalar(t, name)
    qkv = torch.empty((b * np_, 3 * c), dtype=torch.int8, device=x.device)
    ctx = torch.empty((b * np_, c), dtype=torch.int8, device=x.device)
    out = torch.empty_like(x)
    lib = _build.library("attn_block")
    wqkv_t, wp_t = qkv_w.t().contiguous(), proj_w.t().contiguous()
    err = lib.ivit_attn_block(
        _ptr(x), _ptr(ln_bias), _ptr(m_ln), _ptr(ln_shift), _ptr(wqkv_t),
        _ptr(qkv_b), _ptr(m_qkv), _ptr(m_attn), _ptr(s_attn), _ptr(s_exp_act),
        _ptr(m_av), _ptr(wp_t), _ptr(proj_b), _ptr(m_proj), _ptr(m_res_x),
        _ptr(m_res_id), _ptr(qkv), _ptr(ctx), _ptr(out), b, np_, c,
        num_heads, n_valid,
        attn_bits, proj_bits, out_bits, int(bool(fast_exp)),
        int(bool(fast_poly)), _stream())
    _raise_on(err, "attn_block")
    attn_block.launches += 1
    return out


attn_block.launches = 0
