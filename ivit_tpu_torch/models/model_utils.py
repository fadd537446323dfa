"""Model freeze/unfreeze lifecycle helpers (counterpart of
``ivit_tpu/models/model_utils.py``).

Calibration is a flag here (``forward(x, running_stat=True)``), so these
cover the stateful part of the reference's ``fix()`` / ``unfix()``:
fitting or clearing the ppoly tables.
"""

from __future__ import annotations

import torch

from .layers import PPolyGELU, PPolySoftmax


def freeze_model(model):
    """``fix()``: fit the ppoly tables from the calibrated ranges, if the
    model has ppoly sites; returns ``model``, ready for frozen evaluation
    or :func:`ivit_tpu_torch.engine.freeze.freeze_model`."""
    if "ppoly" in (model.gelu_type + model.softmax_type):
        from ..train.ppoly_fit import fit_ppoly_tables
        fit_ppoly_tables(model)
    return model


def unfreeze_model(model):
    """``unfix()``: clear the fitted ppoly tables so that they refit;
    returns ``model``."""
    with torch.no_grad():
        for site in model.modules():
            if isinstance(site, (PPolyGELU, PPolySoftmax)):
                for buf in (site.fitted, site.coeffs, site.bounds):
                    buf.zero_()
    return model
