"""Quantized primitive layers of the QAT sim (counterpart of
``ivit_tpu/models/layers.py``).

Every module keeps the ``(tensor, scaling_factor)`` protocol of the JAX
package: the tensor is a fake-quantized float, exactly ``int * scale``.
The activation ranges of the flax ``quant_stats`` collection are
registered buffers here, with the same names and shapes; ``forward(...,
running_stat=True)`` updates them in place (calibration), ``False`` reads
them (frozen evaluation).  Layouts are the JAX package's: activations
channels-last, linear kernels ``[in, out]``, conv kernels ``[kh, kw, cin,
cout]``, so the two packages' variables map leaf for leaf
(``models/convert.py``).

The integer products (``QuantLinear``, ``QuantConv2d``, ``quant_matmul``)
are f32 matmuls of exact integers, as in JAX; they are exact only while
every partial sum is, which the caller's :func:`exact_f32` context keeps
TF32 from breaking on the card.

On a rank mesh (``parallel.shard_module``) every reduction over a sharded
axis goes through :mod:`~ivit_tpu_torch.parallel.collectives`, which does
nothing without an active mesh: the ranges of every QuantAct, of the
I-BERT softmax's exp requant and of the ppoly sites over the data axis
(and the model axis at the sites ``model_sharded`` marks); a row-sharded
``QuantLinear``'s per-channel weight range and its partial sums over the
model axis (``tp``); ShiftGELU's row max over a hidden row cut in column
shards.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import ibert as ibert_ops
from ..ops import ivit as ivit_ops
from ..ops import quant as q
from ..ops.ppoly import eval_piecewise_poly
from ..parallel import collectives as coll


@contextlib.contextmanager
def exact_f32():
    """Run f32 matmuls and convolutions in full f32, TF32 off, and restore
    the caller's settings after.  TF32 keeps 10 bits of mantissa in each
    operand: exact for the int8 operands, not for the INT16 configuration's
    16-bit probabilities in ``quant_matmul(attn, v)``, and cuDNN allows it
    by default.  The flags are process-wide, so a thread that runs f32
    matmuls beside the sim sees them off while it runs."""
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


def _zeros(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def quantile(x, p: float, dim=None):
    """``jnp.quantile(x, p, axis=dim)`` with its linear interpolation:
    ``pos = f32(p) * (n - 1)``, then ``lo * (1 - w) + hi * w`` with one
    product fused into the add, as XLA:CPU fuses it (``jnp.quantile`` runs
    jitted even when called eagerly; measured on its values): the second
    product for a quantile of the whole tensor, the first for one per
    channel.  A sort and two gathers, so no input size limit
    (``torch.quantile`` refuses inputs of more than 2**24 elements, and
    interpolates with ``lerp``, whose rounding differs)."""
    whole = dim is None
    if whole:
        x, dim = x.reshape(-1), 0
    xs = torch.sort(x, dim=dim).values
    n = xs.shape[dim]
    pos = q.f32(p, x.device) * (q.f32(n, x.device) - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    lo_v = xs.select(dim, int(torch.clamp(lo, 0, n - 1)))
    hi_v = xs.select(dim, int(torch.clamp(hi, 0, n - 1)))
    if whole:
        return q.exact_fma(hi_v, w_hi, lo_v * w_lo)
    return q.exact_fma(lo_v, w_lo, hi_v * w_hi)


class QuantAct(nn.Module):
    """Activation (re)quantizer with running-range EMA (``layers.py:39``):
    momentum 0.95 (``-1``: running min/max), first-batch initialization,
    percentile or per-channel ranges, and the dyadic requant with the
    optional fused residual (``identity``) branch.  On a rank mesh the
    ranges run over the global batch (unless the input is a parameter,
    ``batch_sharded`` False) and over the model axis where the input is
    cut there (``model_sharded``): min / max reduced, a percentile taken of
    the gathered elements, a per-channel range over the data axis (its
    channels are this rank's)."""

    model_sharded = False
    batch_sharded = True

    def __init__(self, activation_bit: int = 8, act_range_momentum: float = 0.95,
                 per_channel: bool = False, channel_len: Optional[int] = None,
                 percentile: Optional[float] = None):
        super().__init__()
        self.activation_bit = activation_bit
        self.act_range_momentum = act_range_momentum
        self.per_channel = per_channel
        self.percentile = percentile
        shape = (channel_len,) if per_channel else (1,)
        self.register_buffer("x_min", _zeros(*shape))
        self.register_buffer("x_max", _zeros(*shape))
        # kept for checkpoint parity with the reference buffer
        self.register_buffer("act_scaling_factor", _zeros(*shape))

    @torch.no_grad()
    def _update_range(self, x_act):
        sharded = self.model_sharded and not self.per_channel
        if self.percentile is None:
            if self.per_channel:
                flat = x_act.reshape(-1, x_act.shape[-1])
                cur_min, cur_max = flat.amin(0), flat.amax(0)
            else:
                cur_min, cur_max = x_act.amin().reshape(1), x_act.amax().reshape(1)
            cur_min, cur_max = coll.reduce_range(cur_min, cur_max, sharded,
                                                 self.batch_sharded)
        else:
            p_lo = (100.0 - self.percentile) / 2.0
            p_hi = 100.0 - p_lo
            axis = coll.range_axis(sharded, self.batch_sharded)
            if self.per_channel:
                flat = coll.all_gather(x_act.reshape(-1, x_act.shape[-1]), axis)
                cur_min = quantile(flat, p_lo / 100.0, dim=0)
                cur_max = quantile(flat, p_hi / 100.0, dim=0)
            else:
                flat = coll.all_gather(x_act.reshape(-1), axis)
                cur_min = quantile(flat, p_lo / 100.0).reshape(1)
                cur_max = quantile(flat, p_hi / 100.0).reshape(1)
        uninit = torch.all(self.x_min == self.x_max)
        if self.act_range_momentum == -1:
            upd_min = torch.minimum(self.x_min, cur_min)
            upd_max = torch.maximum(self.x_max, cur_max)
        else:
            m = self.act_range_momentum
            upd_min = q.ema_update(self.x_min, cur_min, m)
            upd_max = q.ema_update(self.x_max, cur_max, m)
        self.x_min.copy_(torch.where(uninit, self.x_min + cur_min, upd_min))
        self.x_max.copy_(torch.where(uninit, self.x_max + cur_max, upd_max))

    def forward(self, x, pre_scale=None, identity=None, identity_scale=None, *,
                running_stat: bool = False, specified_min=None,
                specified_max=None, exact_int=None):
        if running_stat:
            self._update_range((x if identity is None else x + identity).detach())
        x_min = self.x_min if specified_min is None else specified_min
        x_max = self.x_max if specified_max is None else specified_max
        scale = q.symmetric_quant_params(self.activation_bit, x_min, x_max)
        if running_stat:
            self.act_scaling_factor.copy_(scale)
        if pre_scale is None:
            out = q.fake_quantize(x, self.activation_bit, scale)
        else:
            out = q.fixedpoint_requant(
                x, pre_scale, self.activation_bit, scale, identity=identity,
                identity_scale=identity_scale, exact_int=exact_int)
        return out, scale


class QuantLinear(nn.Module):
    """Linear layer with per-output-channel symmetric weight quantization
    (``layers.py:119``): the weight scale from the float shadow weights
    every forward, the bias on the ``s_w * s_act`` grid (32-bit).

    ``tp``: the tensor-parallel role on a rank mesh -- ``"col"`` (``qkv``,
    ``fc1``: this rank's output columns; f on the input), ``"row"``
    (``proj``, ``fc2``: this rank's input rows; the weight range over the
    model axis, the partial sums through g, the bias added once after) or
    None."""

    tp = None

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 weight_bit: int = 8, bias_bit: int = 32, per_channel: bool = True):
        super().__init__()
        self.weight_bit, self.bias_bit = weight_bit, bias_bit
        self.per_channel = per_channel
        self.kernel = nn.Parameter(_zeros(in_features, out_features))
        self.bias = nn.Parameter(_zeros(out_features)) if use_bias else None

    def forward(self, x, pre_scale):
        w = self.kernel.detach()
        if self.per_channel:
            w_min, w_max = w.amin(0), w.amax(0)
        else:
            w_min, w_max = w.amin().reshape(1), w.amax().reshape(1)
        if self.tp == "row" or (self.tp and not self.per_channel):
            w_min = coll.reduce_min(w_min, "model")
            w_max = coll.reduce_max(w_max, "model")
        fc_scale = q.symmetric_quant_params(self.weight_bit, w_min, w_max)
        w_int = q.quantize_int(self.kernel, self.weight_bit, fc_scale[None, :])
        bias_scale = fc_scale * pre_scale.reshape(-1)
        # the exact-int snap (layers.py:154-161): every operand an exact
        # integer, so every partial sum is exact in f32 and any order of
        # the sum gives the engine's int32 accumulation
        x_int = q.round_ste(q.rdiv(x, pre_scale))
        if self.tp == "col":
            x_int = coll.copy_to_model(x_int)
        out = torch.matmul(x_int, w_int)
        if self.tp == "row":
            out = coll.reduce_from_model(out)
        if self.bias is not None:
            out = out + q.quantize_int(self.bias, self.bias_bit, bias_scale)
        return out * bias_scale, bias_scale


class QuantConv2d(nn.Module):
    """NHWC conv with per-output-channel weight quantization
    (``layers.py:169``), VALID padding; the patch embedding, stride ==
    kernel."""

    def __init__(self, in_channels: int, features: int, kernel_size, strides,
                 use_bias: bool = True, weight_bit: int = 8, bias_bit: int = 32):
        super().__init__()
        self.features, self.weight_bit, self.bias_bit = features, weight_bit, bias_bit
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.kernel = nn.Parameter(_zeros(*self.kernel_size, in_channels, features))
        self.bias = nn.Parameter(_zeros(features)) if use_bias else None

    def forward(self, x, pre_scale):
        w = self.kernel.detach().reshape(-1, self.features)
        conv_scale = q.symmetric_quant_params(self.weight_bit, w.amin(0), w.amax(0))
        w_int = q.quantize_int(self.kernel, self.weight_bit,
                               conv_scale.reshape(1, 1, 1, -1))
        bias_scale = conv_scale * pre_scale.reshape(-1)
        x_int = q.round_ste(q.rdiv(x, pre_scale))
        # The conv as one f32 GEMM over the extracted patches: a plain
        # product of exact integers, where a library convolution may pick
        # a transform algorithm that is not.  DeiT's patch conv sums
        # 16*16*3 = 768 products of at most 128*128, 12.6 M, under 2**24:
        # exact in f32 in any order.
        b, h, wd, cin = x_int.shape
        kh, kw = self.kernel_size
        cols = F.unfold(x_int.permute(0, 3, 1, 2), self.kernel_size,
                        stride=self.strides)              # [B, cin*kh*kw, L]
        w_mat = w_int.permute(2, 0, 1, 3).reshape(cin * kh * kw, self.features)
        out = torch.matmul(cols.transpose(1, 2), w_mat)
        ho = (h - kh) // self.strides[0] + 1
        wo = (wd - kw) // self.strides[1] + 1
        out = out.reshape(b, ho, wo, self.features)
        if self.bias is not None:
            out = out + q.quantize_int(self.bias, self.bias_bit, bias_scale)
        return out * bias_scale, bias_scale


def quant_matmul(a, scale_a, b, scale_b):
    """Integer-valued matmul of two quantized activations
    (``layers.py:214``): ``(A/sA) @ (B/sB) * (sA*sB)``, operands snapped to
    their exact integers."""
    a_int = q.round_ste(q.rdiv(a, scale_a))
    b_int = q.round_ste(q.rdiv(b, scale_b))
    out_scale = (scale_a * scale_b).reshape(-1)
    return torch.matmul(a_int, b_int) * out_scale, out_scale


# ---------------------------------------------------------------------------
# Nonlinearity modules (the registry's targets)
# ---------------------------------------------------------------------------

class IVITGELU(nn.Module):
    """ShiftGELU (``layers.py:228``); ``model_sharded``: the row max over
    the hidden row's column shards."""

    model_sharded = False

    def __init__(self, output_bit: int = 8, n: int = 23):
        super().__init__()
        self.output_bit, self.n = output_bit, n

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        return ivit_ops.shift_gelu(
            x, scaling_factor, self.output_bit, self.n,
            row_max=coll.model_row_max if self.model_sharded else None)


class IVITSoftmax(nn.Module):
    """Shiftmax (``layers.py:237``)."""

    def __init__(self, output_bit: int = 8):
        super().__init__()
        self.output_bit = output_bit

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        return ivit_ops.shiftmax(x, scaling_factor, self.output_bit)


class IVITLayerNorm(nn.Module):
    """I-LayerNorm (``layers.py:245``); returns ``(x, scale, y_int)``, the
    exact integer for the next requant's ``exact_int``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(_zeros(features))

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        return ivit_ops.i_layernorm(x, scaling_factor, self.weight, self.bias)


class IBERTGELU(nn.Module):
    """I-BERT polynomial GELU (``layers.py:260``)."""

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        return ibert_ops.ibert_gelu(x, scaling_factor)


class _ExpRangeAct(nn.Module):
    """16-bit requantizer of I-BERT softmax's raw exp integers
    (``layers.py:271``): the reference's internal QuantAct buffers, and the
    single-rounding ``round(exp_int * rdiv(1, s_act))`` the engine and the
    kernels run."""

    model_sharded = False

    def __init__(self):
        super().__init__()
        self.register_buffer("x_min", _zeros(1))
        self.register_buffer("x_max", _zeros(1))
        self.register_buffer("act_scaling_factor", _zeros(1))

    def forward(self, exp_int, *, running_stat: bool = False):
        if running_stat:
            with torch.no_grad():
                sg = exp_int.detach()
                cur_min, cur_max = coll.reduce_range(
                    sg.amin().reshape(1), sg.amax().reshape(1), self.model_sharded)
                uninit = torch.all(self.x_min == self.x_max)
                self.x_min.copy_(torch.where(uninit, self.x_min + cur_min,
                                             q.ema_update(self.x_min, cur_min, 0.95)))
                self.x_max.copy_(torch.where(uninit, self.x_max + cur_max,
                                             q.ema_update(self.x_max, cur_max, 0.95)))
        s_act = q.symmetric_quant_params(16, self.x_min, self.x_max)
        if running_stat:
            self.act_scaling_factor.copy_(s_act)
        m_exp = q.rdiv(1.0, s_act)
        exp16 = q.clip(q.round_ste(exp_int * m_exp), -(2.0**15), 2.0**15 - 1)
        return exp16, s_act


class IBERTSoftmax(nn.Module):
    """I-BERT softmax with its internal 16-bit exp requant (``layers.py:326``)."""

    def __init__(self, output_bit: int = 8):
        super().__init__()
        self.output_bit = output_bit
        self.act = _ExpRangeAct()

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        exp_int, _ = ibert_ops.ibert_softmax_exp(x, scaling_factor)
        exp16, _ = self.act(exp_int, running_stat=running_stat)
        return ibert_ops.ibert_softmax_normalize(exp16, self.output_bit)


def _batch_max(t):
    """The max of ``t`` over the batch's shards on a rank mesh."""
    return coll.reduce_max(t, "data")


class IBERTLayerNorm(nn.Module):
    """I-BERT LayerNorm with its dynamic overflow shift (``layers.py:337``):
    active exactly while ranges run (the reference's fix()/unfix())."""

    def __init__(self, features: int, output_bit: int = 8, eps: float = 1e-5,
                 use_int_sqrt: bool = False):
        super().__init__()
        self.output_bit, self.eps, self.use_int_sqrt = output_bit, eps, use_int_sqrt
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(_zeros(features))
        self.register_buffer("shift", _zeros(1))

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        y, out_scale, new_shift, y_int = ibert_ops.ibert_layernorm(
            x, scaling_factor, self.weight, self.bias, self.shift,
            overflow_handling=running_stat, use_int_sqrt=self.use_int_sqrt,
            batch_max=_batch_max)
        if running_stat:
            self.shift.copy_(new_shift.reshape(1))
        return y, out_scale, y_int


def _gelu(x):
    return F.gelu(x, approximate="none")


class FloatGELU(nn.Module):
    """Float golden GELU with a quantized output on the input grid
    (``layers.py:361``)."""

    def __init__(self, bitwidth: int = 8):
        super().__init__()
        self.bitwidth = bitwidth

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        n = 2 ** (self.bitwidth - 1)
        y_int = q.clip(q.floor_ste(_gelu(x) / scaling_factor), -n, n - 1)
        return y_int * scaling_factor, scaling_factor


class FloatSoftmax(nn.Module):
    """Float golden softmax with a quantized output (``layers.py:374``)."""

    def __init__(self, bitwidth: int = 8):
        super().__init__()
        self.bitwidth = bitwidth

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        y = torch.softmax(x, dim=-1)
        out_scale = q.f32([2.0 / 2**self.bitwidth], x.device)
        y_int = q.clip(q.floor_ste(y / out_scale), 0, 2 ** (self.bitwidth - 1) - 1)
        return y_int * out_scale, out_scale


class FloatLayerNorm(nn.Module):
    """Float golden LayerNorm with a quantized output (``layers.py:387``)."""

    def __init__(self, features: int, eps: float = 1e-5, bitwidth: int = 8):
        super().__init__()
        self.eps, self.bitwidth = eps, bitwidth
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(_zeros(features))

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        dim_sqrt = q.sqrt_rn(q.f32(x.shape[-1], x.device))
        out_scale = dim_sqrt / 2.0**30 * self.weight
        n = 2 ** (self.bitwidth - 1)
        y_int = q.clip(q.floor_ste(y / out_scale), -n, n - 1)
        return y_int * out_scale, out_scale, y_int


# ---------------------------------------------------------------------------
# Piecewise-polynomial nonlinearities
# ---------------------------------------------------------------------------

class _PPolySite(nn.Module):
    """The fitted-table buffers of a ppoly site (``layers.py:420-431``):
    ``bounds`` / ``coeffs`` (int32, written by ``train.ppoly_fit``),
    ``fitted``, and the calibrated ``x_lo`` / ``x_hi`` / ``in_scale``."""

    model_sharded = False

    def __init__(self, seg: int, deg: int):
        super().__init__()
        self.seg, self.deg = seg, deg
        self.register_buffer("bounds", _zeros(seg - 1, dtype=torch.int32))
        self.register_buffer("coeffs", _zeros(seg, deg + 1, dtype=torch.int32))
        self.register_buffer("fitted", _zeros(1))
        self.register_buffer("x_lo", _zeros(1))
        self.register_buffer("x_hi", _zeros(1))
        self.register_buffer("in_scale", _zeros(1))

    @torch.no_grad()
    def _track(self, v, in_scale):
        lo, hi = coll.reduce_range(v.amin().reshape(1), v.amax().reshape(1),
                                   self.model_sharded)
        self.x_lo.copy_(torch.minimum(self.x_lo, lo))
        self.x_hi.copy_(torch.maximum(self.x_hi, hi))
        self.in_scale.copy_(in_scale.reshape(-1)[:1])

    def _poly(self, x_int):
        return eval_piecewise_poly(x_int.detach(), self.bounds.float(), self.coeffs)

    def _fitted(self):
        return self.fitted[0] > 0


class PPolyGELU(_PPolySite):
    """Piecewise-polynomial integer GELU (``layers.py:403``): the fitted
    table's value once ``fitted``, the backend golden function before, and
    the float GELU's straight-through gradient."""

    def __init__(self, output_bit: int = 8, scale_bits: int = 22, seg: int = 16,
                 deg: int = 2, backend: str = "ibert", alpha: float = 0.0,
                 optim_bounds: bool = True):
        super().__init__(seg, deg)
        self.output_bit, self.scale_bits, self.backend = output_bit, scale_bits, backend
        self.alpha, self.optim_bounds = alpha, optim_bounds

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        if running_stat:
            self._track(x.detach(), scaling_factor)
        s = scaling_factor
        if self.backend == "ibert":
            so = (q.rdiv(s, ibert_ops.GELU_K) ** 2 * ibert_ops.GELU_A
                  * (2**ibert_ops.GELU_N))
            out_scale = s * so / 2
        else:
            out_scale = s / (2.0**self.scale_bits)
        out_scale = out_scale.detach()
        # round_ste snap of the true integer (layers.py:458-466)
        x_int = q.round_ste(q.rdiv(x, s))
        y_poly = self._poly(x_int) / (2.0**self.scale_bits)
        if self.backend == "ibert":
            y_golden, _ = ibert_ops.ibert_gelu(x, s)
        else:
            y_golden = _gelu(x)
        y_val = torch.where(self._fitted(), y_poly, y_golden.detach())
        g = _gelu(x)
        y = y_val.detach() + (g - g.detach())
        return out_scale * q.floor_ste(q.rdiv(y, out_scale)), out_scale


class PPolySoftmax(_PPolySite):
    """Piecewise-polynomial integer softmax (``layers.py:490``) on the
    offset grid ``x - max + 127``, with the float softmax's
    straight-through gradient."""

    def __init__(self, output_bit: int = 8, scale_bits: int = 28, exp_bits: int = 16,
                 seg: int = 16, deg: int = 2, backend: str = "float",
                 alpha: float = 0.0, optim_bounds: bool = False):
        super().__init__(seg, deg)
        self.output_bit, self.scale_bits, self.exp_bits = output_bit, scale_bits, exp_bits
        self.backend, self.alpha, self.optim_bounds = backend, alpha, optim_bounds

    def forward(self, x, scaling_factor, *, running_stat: bool = False):
        s = scaling_factor.reshape(-1)[:1]
        x_int = q.round_ste(q.rdiv(x, s))
        x_off = x_int - torch.amax(x_int.detach(), dim=-1, keepdim=True) + 127
        if running_stat:
            self._track(x_off.detach(), s)
        off = x_off.detach()
        exp_poly = torch.clamp(self._poly(off), min=0)
        exp_golden = torch.exp((off - 127) * s) * (2.0**self.scale_bits)
        exp_int = torch.where(self._fitted(), exp_poly, exp_golden)
        exp_int = torch.floor(exp_int / 2 ** (30 - self.exp_bits + 1))
        # the row sum exact, then rounded once (ops/ppoly.ppoly_softmax_int):
        # JAX's f32 sum is the same value while the sum stays below 2**24
        total = torch.clamp(exp_int.double().sum(dim=-1, keepdim=True).float(), min=1.0)
        factor = torch.floor(q.rdiv(2.0**32, total))
        softmax_int = torch.floor(exp_int * factor / 2 ** (32 - self.output_bit + 1))
        out_scale = q.f32([2.0 / 2**self.output_bit], x.device)
        y_float = torch.softmax(x, dim=-1)
        y = (softmax_int * out_scale).detach() + (y_float - y_float.detach())
        return out_scale * q.floor_ste(y / out_scale), out_scale


def trunc_normal_init(t, std: float, generator):
    """flax's ``truncated_normal(std)``: a normal cut at +-2 standard
    deviations, rescaled so that the cut distribution has ``std``."""
    s = std / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s,
                                     generator=generator)

