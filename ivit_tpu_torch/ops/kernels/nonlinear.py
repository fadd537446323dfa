"""The standalone kernels, for Hopper: the two ivit nonlinearities and the
integer LayerNorm + int8 requant.

``shiftmax`` replaces ``ivit_tpu/ops/pallas/nonlinear.py::shiftmax_p`` and
``shift_gelu_requant`` replaces ``shift_gelu_requant_p``.  ``ln_requant``
replaces no Pallas kernel: it runs the LayerNorms the engines have outside
their block kernels (JAX leaves them to XLA), one launch each in place of
about 250 torch ops and a host scalar copied to the card (see its source
note in ``csrc/nonlinear.cu``).  Each wrapper
launches the hand-written CUDA kernel (``ivit_tpu_torch/csrc/nonlinear.cu``)
for a tensor on the card and runs its plain PyTorch version,
``shiftmax_ref`` / ``shift_gelu_requant_ref`` / ``ln_requant_ref``, for a
tensor on the CPU.  The plain versions are the integer cores of
:mod:`ivit_tpu_torch.ops.ivit` (and the engines' LN chain), which the
Pallas kernel bodies (``_shiftmax_kernel``, ``_shift_gelu_kernel``) equal
bit for bit; on the card they are what the kernels are held against.

The scale operands are one-element f32 tensors (the spec's 0-d leaves);
the kernels read them and derive ``s_gelu * 1.702``, the exp constants and
the LN shift's power of two in every thread, so a call launches the kernel
and nothing else (``shift_gelu_requant``: its table of every (row max,
value) output, then the rows, counted as one).  Each wrapper counts its
launches in a plain integer attribute (``shiftmax.launches``,
``shift_gelu_requant.launches``, ``ln_requant.launches``), incremented only
where the kernel is launched; none transposes anything.  The whole of each
wrapper call is the span ``ivit.kernel.<wrapper>``
(:mod:`ivit_tpu_torch.utils.spans`: recorded only while a profiler
records).
"""

from __future__ import annotations

import torch

from ...utils.spans import spanned
from .. import ivit as iv
from . import _build
from .block import (_STREAM, GELU_TABLE_BYTES, _check, _check_scalar, _ln8,
                    _ln_kind, _ptr, _raise_on, _stream, container, to_container)

LN_MAX_WIDTH = 2048     # csrc/nonlinear.cu kMaxLnWidth: Swin-B's last merge norm


def shiftmax_ref(scores, s_attn, output_bit=8, *, n_valid=None, fast_q=False):
    """Plain version of the Shiftmax kernel: int8 scores [..., N] -> probs
    in the ``output_bit`` container (int8 up to 8 bits, int16 up to 16),
    saturating at its range."""
    probs, _ = iv.shiftmax_int(scores.float(), s_attn, output_bit,
                               n_valid=n_valid, fast_q=fast_q)
    return to_container(probs, output_bit)


def shift_gelu_requant_ref(x, s_gelu, m_out, output_bit=8, n=23, out_bits=8,
                           *, fast_q=False):
    """Plain version of the ShiftGELU + requant kernel: int8 [..., H] ->
    int8 at the next scale, ``clip(round(shift_gelu(x) * m_out))``."""
    y, _ = iv.shift_gelu_int(x.float(), s_gelu, output_bit, n, fast_q=fast_q)
    lim = 2.0 ** (out_bits - 1)
    return torch.clamp(torch.round(y * m_out), -lim, lim - 1).to(torch.int8)


@spanned("ivit.kernel.shiftmax")
def shiftmax(scores, s_attn, output_bit=8, *, n_valid=None, fast_q=False):
    """Row Shiftmax over the last axis of int8 ``scores``; columns >=
    ``n_valid`` are padding (probability 0)."""
    if scores.device.type == "cpu":
        return shiftmax_ref(scores, s_attn, output_bit, n_valid=n_valid,
                            fast_q=fast_q)
    n = scores.shape[-1]
    n_valid = n if n_valid is None else n_valid
    if not (0 < n_valid <= n <= 1024 and 1 < output_bit <= 16):
        raise ValueError(f"shiftmax kernel takes rows of at most 1024 with "
                         f"0 < n_valid <= N and output bits in 2..16; got "
                         f"N={n}, n_valid={n_valid}, bits={output_bit}")
    # any base address: the kernel moves a tensor that is not 16-byte
    # aligned through its byte path
    _check(scores, "scores", torch.int8, tuple(scores.shape), align=1)
    _check_scalar(s_attn, "s_attn")
    out = torch.empty(scores.shape, dtype=container(output_bit),
                      device=scores.device)
    err = _build.library("nonlinear").ivit_shiftmax(
        _ptr(scores), _ptr(s_attn), _ptr(out), scores.numel() // n, n,
        n_valid, output_bit, int(bool(fast_q)), _stream())
    _raise_on(err, "shiftmax")
    shiftmax.launches += 1
    return out


shiftmax.launches = 0


@spanned("ivit.kernel.shift_gelu_requant")
def shift_gelu_requant(x, s_gelu, m_out, output_bit=8, n=23, out_bits=8, *,
                       fast_q=False):
    """Row ShiftGELU + requant over the last axis of int8 ``x``; the row max
    runs over the whole axis."""
    if x.device.type == "cpu":
        return shift_gelu_requant_ref(x, s_gelu, m_out, output_bit, n,
                                      out_bits, fast_q=fast_q)
    if not (1 < output_bit <= 16 and 1 < out_bits <= 8 and 0 < n <= 30):
        raise ValueError(f"shift_gelu_requant kernel takes sigmoid bits in "
                         f"2..16, output bits in 2..8 and n in 1..30; got "
                         f"{output_bit}, {out_bits}, {n}")
    _check(x, "x", torch.int8, tuple(x.shape))
    _check_scalar(s_gelu, "s_gelu")
    _check_scalar(m_out, "m_out")
    h = x.shape[-1]
    out = torch.empty_like(x)
    table = torch.empty(GELU_TABLE_BYTES, dtype=torch.int8, device=x.device)
    err = _build.library("nonlinear").ivit_shift_gelu_requant(
        _ptr(x), _ptr(s_gelu), _ptr(m_out), _ptr(out), x.numel() // h, h,
        output_bit, n, out_bits, int(bool(fast_q)), _ptr(table), _stream())
    _raise_on(err, "shift_gelu_requant")
    shift_gelu_requant.launches += 1
    return out


shift_gelu_requant.launches = 0


def ln_requant_ref(x, ln_bias, m_ln, ln_shift, ln_base="ibert",
                   use_int_sqrt=False):
    """Plain version of the LN + requant kernel, the engines' chain: int8 or
    int16 ``x`` [..., C] -> int8, ``clip(round((LN(x) + ln_bias) *
    m_ln))`` with I-LayerNorm or the ibert LN at its frozen shift
    (floor(sqrt), or I-BERT's integer sqrt with ``use_int_sqrt``), a NaN
    row pinned to 0."""
    return _ln8(x, ln_base, ln_bias, ln_shift, m_ln, None, use_int_sqrt)


@spanned("ivit.kernel.ln_requant")
def ln_requant(x, ln_bias, m_ln, ln_shift, ln_base="ibert", use_int_sqrt=False):
    """Integer LayerNorm + int8 requant over the last axis of ``x`` (int8 or
    int16, C a multiple of 16 up to 2,048; any view whose rows lie at one
    stride on 16-byte boundaries, such as ViT's cls rows ``x[:, :1]``, is
    read in place); ``ln_bias`` and ``m_ln`` f32 [C], ``ln_shift`` the
    spec's one-element shift (read by the ibert LN).  Returns a contiguous
    int8 tensor of ``x``'s shape."""
    if x.device.type == "cpu":
        return ln_requant_ref(x, ln_bias, m_ln, ln_shift, ln_base, use_int_sqrt)
    c = x.shape[-1]
    rows = x.reshape(-1, c)       # a view wherever the rows share a stride
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    if ln_base not in ("ivit", "ibert") or x.dtype not in _STREAM \
            or not 0 < c <= LN_MAX_WIDTH or c % 16 \
            or (rows.data_ptr() | rows.stride(0) * rows.element_size()) % 16:
        raise ValueError(f"ln_requant kernel takes the ivit or ibert LN of "
                         f"int8 or int16 rows of a multiple of 16 columns, up "
                         f"to {LN_MAX_WIDTH}, on 16-byte boundaries; got "
                         f"{ln_base!r}, x {x.dtype} {tuple(x.shape)}")
    _check(ln_bias, "ln_bias", torch.float32, (c,))
    _check(m_ln, "m_ln", torch.float32, (c,))
    _check_scalar(ln_shift, "ln_shift")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    err = _build.library("nonlinear").ivit_ln_requant(
        _ptr(rows), rows.stride(0), _ptr(ln_bias), _ptr(m_ln), _ptr(ln_shift),
        _ptr(out), rows.shape[0], c, int(x.dtype == torch.int16),
        _ln_kind(ln_base, use_int_sqrt), _stream())
    _raise_on(err, "ln_requant")
    ln_requant.launches += 1
    return out


ln_requant.launches = 0
