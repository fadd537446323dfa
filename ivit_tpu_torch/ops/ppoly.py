"""Piecewise-polynomial integer approximations, the ppoly family
(counterpart of ``ivit_tpu/ops/ppoly.py`` and of the fitting pass of
``ivit_tpu/train/ppoly_fit.py``).

* The host-side fit (numpy, freeze time): least-squares pieces on
  [-1, 1]-normalized coordinates, optional coordinate-descent boundary
  search, integer coefficients ``floor(c_k * s**k * 2**N)``.  The port
  needs it because the card has no JAX: the synthetic ppoly specs
  (``engine/synthetic.py``) are fitted with it.  The ibert backend's
  golden functions run on the port's own ibert cores, f32 as JAX runs
  them.
* The integer evaluation (torch): segment ``i`` covers
  ``bounds[i-1] <= x < bounds[i]`` (a comparison count), Horner highest
  power first, each step an f32 multiply then an f32 add, never an FMA
  (PyTorch runs each op as its own kernel).
* The ppoly softmax and the GELU epilogue of the engines and the fused
  kernels' plain versions.

The fitted bounds are non-decreasing (each boundary search stays between
its neighbours, and ``floor(b / s)`` keeps the order), so the count here
and the kernels' select chain (``csrc/ppoly.cuh``, ``block.py``
``_ppoly_eval``) pick the same segment.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from . import ibert as _ib
from .quant import f32, rdiv


# ---------------------------------------------------------------------------
# Host-side fitting (numpy, freeze time)
# ---------------------------------------------------------------------------

def optimize_segment_bounds(xs, ys, x_lo, x_hi, segments, degree, max_iter=10):
    """Coordinate-descent boundary optimization (``ppoly.py:45``)."""
    MIN_WIDTH_DIVISOR = 4
    SEARCH_RANGE_FACTOR = 0.3
    SEARCH_STEPS = 10

    bounds = np.linspace(x_lo, x_hi, segments + 1, dtype=np.float32)
    min_width = (x_hi - x_lo) / (segments * MIN_WIDTH_DIVISOR)

    for _ in range(max_iter):
        for i in range(1, segments):
            lo_search = max(bounds[i - 1] + min_width,
                            bounds[i] - SEARCH_RANGE_FACTOR * (bounds[i + 1] - bounds[i - 1]))
            hi_search = min(bounds[i + 1] - min_width,
                            bounds[i] + SEARCH_RANGE_FACTOR * (bounds[i + 1] - bounds[i - 1]))
            if lo_search >= hi_search:
                continue
            best_pos, best_error = bounds[i], float("inf")
            for pos in np.linspace(lo_search, hi_search, SEARCH_STEPS):
                bounds_test = bounds.copy()
                bounds_test[i] = pos
                total_error = 0.0
                for j in range(segments):
                    mask = (xs >= bounds_test[j]) & (xs <= bounds_test[j + 1])
                    if mask.any():
                        with warnings.catch_warnings():
                            warnings.simplefilter("ignore")
                            coeffs = np.polyfit(xs[mask], ys[mask], degree)
                        total_error += float(np.sum((ys[mask] - np.polyval(coeffs, xs[mask])) ** 2))
                if total_error < best_error:
                    best_error, best_pos = total_error, pos
            bounds[i] = best_pos
    return bounds


def fit_piecewise_polynomials(xs, ys, x_lo, x_hi, segments, degree,
                              alpha=0.0, optim_bounds=True):
    """Least-squares piecewise fit (``ppoly.py:80``): a list of ``((lo,
    hi), coeffs)``, coeffs highest power first, fitted on [-1, 1]-normalized
    coordinates and expanded back binomially."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    x_lo, x_hi = float(x_lo), float(x_hi)

    if optim_bounds:
        bounds = optimize_segment_bounds(xs, ys, x_lo, x_hi, segments, degree)
    else:
        bounds = np.linspace(x_lo, x_hi, segments + 1, dtype=np.float32)

    segment_width = (x_hi - x_lo) / segments
    overlap_width = alpha * segment_width
    pieces = []
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        fit_lo = lo - overlap_width if i > 0 else lo
        fit_hi = hi + overlap_width if i < segments - 1 else hi
        mask = (xs >= fit_lo) & (xs <= fit_hi)
        x_fit, y_fit = xs[mask], ys[mask]

        if len(x_fit) > degree:
            x_center = (fit_lo + fit_hi) / 2.0
            x_scale = (fit_hi - fit_lo) / 2.0
            if abs(x_scale) < 1e-10:
                x_scale = 1.0
            x_norm = (x_fit - x_center) / x_scale
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                coeffs_norm = np.polyfit(x_norm, y_fit, degree)
            coeffs = np.zeros(degree + 1, dtype=np.float64)
            for j in range(degree + 1):
                poly_power = degree - j
                coeff_norm = coeffs_norm[j]
                for k in range(poly_power + 1):
                    binom = math.comb(poly_power, k)
                    contrib = (coeff_norm * binom
                               * ((-x_center / x_scale) ** (poly_power - k))
                               / (x_scale**k))
                    coeffs[degree - k] += contrib
            coeffs = coeffs.astype(np.float32)
        else:
            coeffs = np.zeros(degree + 1, dtype=np.float32)
            if len(y_fit) > 0:
                coeffs[-1] = float(np.mean(y_fit))
        pieces.append(((float(lo), float(hi)), coeffs))
    return pieces


def compute_integer_coefficients(float_pieces, scaling_factor, N):
    """Float pieces -> (internal bounds int32 [seg-1], coeffs int64
    [seg, deg+1], signed bit-widths by power) (``ppoly.py:134``):
    ``coeff_int = floor(c_k * s**k * 2**N)``, bounds ``floor(lo / s)``."""
    s = float(np.asarray(scaling_factor).reshape(-1)[0])
    bounds, int_coeffs, bitwidths = [], [], {}
    for idx, ((lo_f, _hi_f), coeffs) in enumerate(float_pieces):
        if idx > 0:
            bounds.append(math.floor(lo_f / s))
        deg = len(coeffs) - 1
        row = []
        for i, coeff in enumerate(coeffs):
            power = deg - i
            int_coeff = math.floor(float(coeff) * (s**power) * (2.0**N))
            bw = 1 if int_coeff == 0 else int(math.ceil(math.log2(abs(int_coeff) + 1))) + 1
            bitwidths[power] = max(bitwidths.get(power, 0), bw)
            row.append(int_coeff)
        int_coeffs.append(row)
    return (np.asarray(bounds, dtype=np.int32),
            np.asarray(int_coeffs, dtype=np.int64), bitwidths)


@dataclasses.dataclass(frozen=True)
class PPolyTable:
    """Frozen integer piecewise polynomial: internal bounds + coefficients."""
    bounds: np.ndarray        # int32 [segments-1]
    coeffs: np.ndarray        # int64 [segments, degree+1], highest power first
    scale_bits: int           # N
    out_scale: np.ndarray     # float, output scaling factor


def _gelu_ref(x):
    return 0.5 * x * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def _ibert_gelu_host(xs, s):
    """The ibert GELU on fake-quant floats, f32 as ``ibert.ibert_gelu``
    computes it: the golden function of the ibert GELU backend."""
    x = torch.as_tensor(np.asarray(xs, dtype=np.float32))
    s = f32(s)
    y_int, out_scale = _ib.ibert_gelu_int(rdiv(x, s), s)
    return (y_int * out_scale).numpy().astype(np.float64)


def _ibert_exp_host(x_int, s):
    """The ibert integer exp, ``int_exp``'s value times its scale in
    float64: the golden function of the ibert softmax backend."""
    e_int, e_scale = _ib.int_exp(torch.as_tensor(np.asarray(x_int, dtype=np.float32)),
                                 f32(s))
    return (np.asarray(e_int.numpy(), np.float64)
            * np.asarray(e_scale.numpy(), np.float64))


def fit_gelu_table(x_lo, x_hi, scaling_factor, *, scale_bits=22, seg=16,
                   deg=2, backend="ibert", alpha=0.0, optim_bounds=True) -> PPolyTable:
    """Fit the GELU ppoly table over the real range [x_lo, x_hi]
    (``ppoly.py:199``)."""
    x_lo = math.floor(x_lo)
    x_hi = math.ceil(x_hi)
    s = float(np.asarray(scaling_factor).reshape(-1)[0])
    xs = np.linspace(x_lo, x_hi, 10000)
    ys = _ibert_gelu_host(xs, s) if backend == "ibert" else _gelu_ref(xs)
    pieces = fit_piecewise_polynomials(xs, ys, x_lo, x_hi, seg, deg, alpha,
                                       optim_bounds=optim_bounds)
    bounds, coeffs, _ = compute_integer_coefficients(pieces, s, scale_bits)
    if backend == "ibert":
        # IBERT's composite output scale, in Python floats as JAX's
        so = s / _ib.GELU_K
        so = so**2 * _ib.GELU_A
        so = so * (2**_ib.GELU_N)
        out_scale = np.asarray(s * so / 2, dtype=np.float32)
    else:
        out_scale = np.asarray(s / (2.0**scale_bits), dtype=np.float32)
    return PPolyTable(bounds=bounds, coeffs=coeffs, scale_bits=scale_bits,
                      out_scale=out_scale)


def fit_softmax_exp_table(x_lo_int, x_hi_int, scaling_factor, *, scale_bits=28,
                          seg=16, deg=2, backend="float", alpha=0.0,
                          optim_bounds=False) -> PPolyTable:
    """Fit the softmax exp ppoly table on the offset integer grid
    ``x_int - max + 127``, fitting ``exp((x_off - 127) * s)``
    (``ppoly.py:227``)."""
    s = float(np.asarray(scaling_factor).reshape(-1)[0])
    x_lo_int = math.floor(x_lo_int)
    x_hi_int = math.ceil(x_hi_int)
    xs_off = np.linspace(x_lo_int, x_hi_int, 10000)
    if backend == "ibert":
        ys = _ibert_exp_host(xs_off - 127, s)
    else:
        ys = np.exp((xs_off - 127) * s)
    xs = xs_off * s
    x_lo, x_hi = x_lo_int * s, x_hi_int * s
    pieces = fit_piecewise_polynomials(xs, ys, x_lo, x_hi, seg, deg, alpha,
                                       optim_bounds=optim_bounds)
    bounds, coeffs, _ = compute_integer_coefficients(pieces, s, scale_bits)
    return PPolyTable(bounds=bounds, coeffs=coeffs, scale_bits=scale_bits,
                      out_scale=np.asarray(1.0, dtype=np.float32))


def fit_site(kind, x_lo, x_hi, in_scale, type_params):
    """One ppoly site's engine leaves from its calibrated range, as
    ``train/ppoly_fit.py::fit_ppoly_tables`` fits a site and
    ``freeze_model`` reads it: ``kind`` "softmax" or "gelu", the family's
    type parameters (``EngineConfig.type_params``) with the layers' and the
    fit's defaults (16 segments of degree 2).  Returns ``(bounds int32
    [seg-1], coeffs f32 [seg, deg+1])``:
    the coefficients clipped to int32, as the quant_stats buffers hold
    them, then stored as f32 (a coefficient past 2**31 really clips at
    small scales)."""
    kw = dict(type_params)
    seg, deg = int(kw.get("seg", 16)), int(kw.get("deg", 2))
    if kind == "softmax":
        table = fit_softmax_exp_table(
            x_lo, x_hi, in_scale, scale_bits=int(kw.get("scale_bits", 28)),
            seg=seg, deg=deg, backend=str(kw.get("backend", "float")),
            alpha=float(kw.get("alpha", 0.0)),
            optim_bounds=bool(kw.get("optim_bounds", False)))
    elif kind == "gelu":
        table = fit_gelu_table(
            x_lo, x_hi, in_scale, scale_bits=int(kw.get("scale_bits", 22)),
            seg=seg, deg=deg, backend=str(kw.get("backend", "ibert")),
            alpha=float(kw.get("alpha", 0.0)),
            optim_bounds=bool(kw.get("optim_bounds", True)))
    else:
        raise ValueError(f"ppoly site kind {kind!r}: want 'softmax' or 'gelu'")
    coeffs = np.clip(table.coeffs, -(2**31), 2**31 - 1).astype(np.int32)
    return np.asarray(table.bounds, np.int32), coeffs.astype(np.float32)


# ---------------------------------------------------------------------------
# Integer evaluation (torch)
# ---------------------------------------------------------------------------

def eval_piecewise_poly(x_int, bounds, coeffs):
    """Integer Horner evaluation of f32-held integers ``x_int``
    (``ppoly.py:256``): ``bounds`` [seg-1] the internal boundaries,
    ``coeffs`` [seg, deg+1] highest power first.  Segment ``i`` covers
    ``bounds[i-1] <= x < bounds[i]`` (the count of boundaries ``<= x``);
    each element takes exactly its segment's coefficients; each Horner step
    is an f32 multiply, then an f32 add."""
    bounds, coeffs = (
        (t.float() if isinstance(t, torch.Tensor)
         else torch.from_numpy(np.array(t, np.float32))).to(x_int.device)
        for t in (bounds, coeffs))
    seg_idx = torch.zeros(x_int.shape, dtype=torch.int64, device=x_int.device)
    for j in range(bounds.numel()):
        seg_idx += (x_int >= bounds[j]).long()
    r = coeffs[:, 0][seg_idx]
    for k in range(1, coeffs.shape[1]):
        r = r * x_int + coeffs[:, k][seg_idx]
    return r


def ppoly_softmax_int(x, bounds, coeffs, exp_bits, output_bit, n_valid=None):
    """The ppoly softmax of f32 integer scores over the last axis
    (``engine/vit_int.py`` ppoly branch, ``block.py::_ppoly_softmax``):
    offset ``x - max + 127``, the polynomial exp on the 2**30 grid clipped
    at 0, floored onto the ``exp_bits`` grid, the row sum clamped to >= 1,
    ``factor = floor(2**32 / sum)``, ``floor(exp * factor / 2**(33 -
    output_bit))``.  Columns >= ``n_valid`` are padding: out of the max
    (filled with -2**23) and exp 0.

    The row sum is exact, then rounded to f32 once (float64 holds every
    partial sum of integers below 2**53): where the f32 sum of JAX is
    exact, which holds for every row whose sum stays below 2**24, the two
    agree, in any order; where it is not, JAX's own value depends on the
    order of its adds and the port takes the exact one."""
    mask = None
    if n_valid is not None and n_valid != x.shape[-1]:
        mask = torch.arange(x.shape[-1], device=x.device) < n_valid
        x = torch.where(mask, x, torch.full_like(x, -(2.0**23)))
    x_off = x - torch.amax(x, dim=-1, keepdim=True) + 127
    e = torch.clamp(eval_piecewise_poly(x_off, bounds, coeffs), min=0)
    e = torch.floor(e / 2 ** (30 - exp_bits + 1))
    if mask is not None:
        e = torch.where(mask, e, torch.zeros_like(e))
    total = torch.clamp(e.double().sum(dim=-1, keepdim=True).float(), min=1.0)
    factor = torch.floor(rdiv(2.0**32, total))
    return torch.floor(e * factor / 2 ** (32 - output_bit + 1))


def ppoly_gelu_int(x_int, bounds, coeffs, scale_bits, s_out, fastdiv=False,
                   s_out_c=None, patch_h=None, patch_d=None):
    """The ppoly GELU on f32 integers, onto its backend's output grid
    (``engine/vit_int.py`` ppoly branch of ``_gelu_int``): Horner ints on
    the ``2**scale_bits`` grid, then ``floor(rdiv(y / 2**scale_bits,
    s_out))``, or with ``fastdiv`` (the freeze gate's proof over the int8
    domain) ``floor(y * s_out_c)`` plus the patches ``patch_d[j]`` where
    ``x == patch_h[j]``."""
    y = eval_piecewise_poly(x_int, bounds, coeffs)
    if fastdiv:
        g = torch.floor(y * f32(s_out_c, x_int.device))
        ph = f32(patch_h, x_int.device)
        pd = f32(patch_d, x_int.device)
        for j in range(ph.numel()):
            g = g + torch.where(x_int == ph[j], pd[j], torch.zeros_like(g))
        return g
    return torch.floor(rdiv(y / 2.0**scale_bits, f32(s_out, x_int.device)))
