"""Host-side piecewise-polynomial fitting pass over a calibrated QAT sim
(counterpart of ``ivit_tpu/train/ppoly_fit.py``).

The ppoly layers track their observed input range and scale in their
buffers while calibrating; this pass walks the model once, runs the numpy
least-squares fit (``ops/ppoly.py``) for every site that has been
calibrated, and writes the integer tables back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.layers import PPolyGELU, PPolySoftmax
from ..models.registry import parse_layer_name
from ..ops.ppoly import fit_gelu_table, fit_softmax_exp_table


def fit_ppoly_tables(model):
    """Fit every calibrated ppoly site of ``model`` in place (a site with
    ``in_scale`` 0 or an empty range was never calibrated and is left as
    it is); returns ``model``."""
    _, gelu_kw = parse_layer_name(model.gelu_type)
    _, sm_kw = parse_layer_name(model.softmax_type)
    for site in model.modules():
        if not isinstance(site, (PPolyGELU, PPolySoftmax)):
            continue
        in_scale, x_lo, x_hi = (float(getattr(site, k).reshape(-1)[0])
                                for k in ("in_scale", "x_lo", "x_hi"))
        if in_scale == 0.0 or x_lo == x_hi:
            continue
        seg, deg = site.coeffs.shape[0], site.coeffs.shape[1] - 1
        if isinstance(site, PPolySoftmax):
            kw = sm_kw
            table = fit_softmax_exp_table(
                x_lo, x_hi, in_scale, scale_bits=int(kw.get("scale_bits", 28)),
                seg=seg, deg=deg, backend=str(kw.get("backend", "float")),
                alpha=float(kw.get("alpha", 0.0)),
                optim_bounds=bool(kw.get("optim_bounds", False)))
        else:
            kw = gelu_kw
            table = fit_gelu_table(
                x_lo, x_hi, in_scale, scale_bits=int(kw.get("scale_bits", 22)),
                seg=seg, deg=deg, backend=str(kw.get("backend", "ibert")),
                alpha=float(kw.get("alpha", 0.0)),
                optim_bounds=bool(kw.get("optim_bounds", True)))
        coeffs = np.clip(table.coeffs, -(2**31), 2**31 - 1).astype(np.int32)
        with torch.no_grad():
            site.bounds.copy_(torch.from_numpy(np.asarray(table.bounds, np.int32)))
            site.coeffs.copy_(torch.from_numpy(coeffs))
            site.fitted.fill_(1.0)
    return model
