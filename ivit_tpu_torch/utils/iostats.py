"""Per-layer IO-statistics tracing (counterpart of
``ivit_tpu/utils/iostats.py``; the reference's forward-hook table).

Every quantized module of the sims returns ``(tensor, scale)``: one
instrumented forward records, for each module output of that form, its
float and integer extrema, its scale and its shape -- the table
``scripts/analyze_io_stats.py`` sizes hardware datapaths from.  Forward
hooks stand in for flax's ``capture_intermediates``; the rows carry JAX's
fields, the layer paths in flax naming (``blocks_0/attn/qkv``), in JAX's
order: sorted by path, as ``jax.device_get`` rebuilds the captured tree
with sorted keys (a module's own output before its children's, repeated
calls in call order).

API: attach_io_stats / enable_io_stats / disable_io_stats /
clear_io_stats / get_io_stats / save_io_stats.  There is no pandas:
``get_io_stats`` gives the rows as a list of dicts and ``save_io_stats``
writes the CSV ``DataFrame.to_csv(index=False)`` writes.
"""

from __future__ import annotations

import csv
import math
from typing import List

import torch

_LAYER_IO_STATS: List[dict] = []
_IO_STATS_ENABLED = True


def enable_io_stats():
    global _IO_STATS_ENABLED
    _IO_STATS_ENABLED = True


def disable_io_stats():
    global _IO_STATS_ENABLED
    _IO_STATS_ENABLED = False


def clear_io_stats():
    _LAYER_IO_STATS.clear()


def _is_pair(value):
    return (isinstance(value, tuple) and len(value) == 2
            and isinstance(value[0], torch.Tensor))


def _nan_extrema(t):
    """(nanmin, nanmax) of ``t`` as numpy's, NaN where every value is."""
    nan = torch.isnan(t)
    inf = torch.tensor(math.inf, dtype=t.dtype, device=t.device)
    lo = torch.where(nan, inf, t).amin()
    hi = torch.where(nan, -inf, t).amax()
    every = nan.all()
    return torch.where(every, torch.nan, lo), torch.where(every, torch.nan, hi)


def _extrema(out, scale):
    """The record's numbers as one f32 tensor on the output's device:
    min, max, and with a scale the integer extrema of ``out / scale``."""
    vals = [out.amin(), out.amax()]
    if scale is not None and scale.numel():
        vals += _nan_extrema(out / scale)
    return torch.stack([v.float() for v in vals])


def _record(path: str, out, scale, numbers):
    rec = {
        "layer": path,
        "type": path.rsplit("/", 1)[-1],
        "min_out": numbers[0],
        "max_out": numbers[1],
        "scale_out": (float(scale.reshape(-1)[0])
                      if scale is not None and scale.numel() else None),
        "shape_out": tuple(out.shape),
    }
    if len(numbers) == 4:
        rec["min_out_int"] = numbers[2]
        rec["max_out_int"] = numbers[3]
    _LAYER_IO_STATS.append(rec)


def _order(path):
    """JAX's walk order: the captured tree's keys sorted at every level, a
    module's own outputs under its ``__call__`` key."""
    return tuple(path.split("/") if path else ()) + ("__call__",)


def attach_io_stats(model):
    """Returns ``fwd(x)``: one forward of the sim ``model`` (frozen ranges,
    ``running_stat=False``, no gradient) that records every submodule's
    ``(tensor, scale)`` output into the stats buffer; returns the logits."""
    from ..models.convert import _flax_path

    names = {mod: "/".join(_flax_path(name)) for name, mod in model.named_modules()}

    def fwd(x):
        outs = {}

        def hook(mod, args, out):
            if _IO_STATS_ENABLED and _is_pair(out):
                scale = out[1] if isinstance(out[1], torch.Tensor) else None
                outs.setdefault(names[mod], []).append(
                    (out[0].detach(), None if scale is None else scale.detach()))

        handles = [m.register_forward_hook(hook) for m in names]
        try:
            with torch.no_grad():
                logits = model(x, running_stat=False)
        finally:
            for h in handles:
                h.remove()
        rows = [(path or "<model>", out, scale)
                for path in sorted(outs, key=_order) for out, scale in outs[path]]
        if rows:
            # one device read for the whole table
            numbers = torch.cat([_extrema(o, s) for _, o, s in rows]).tolist()
            i = 0
            for path, out, scale in rows:
                k = 4 if scale is not None and scale.numel() else 2
                _record(path, out, scale, numbers[i:i + k])
                i += k
        return logits

    return fwd


def get_io_stats() -> List[dict]:
    """The recorded rows (copies), in recording order."""
    return [dict(r) for r in _LAYER_IO_STATS]


def _cell(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def save_io_stats(path: str):
    """Write the rows to ``path`` as CSV: one column per field in the order
    the fields first appear, a missing value as an empty cell, floats as
    ``repr`` gives them (the text of JAX's ``to_csv(index=False)``).
    Returns the rows.  A ``.pkl`` path raises: the port does not pickle
    (JAX's pickles a pandas DataFrame; the card has no pandas)."""
    if path.endswith(".pkl"):
        raise ValueError(f"{path}: the port writes IO stats as CSV only (JAX's "
                         ".pkl is a pickled pandas DataFrame; the port has no "
                         "pandas): use a .csv path")
    rows = get_io_stats()
    fields = list(dict.fromkeys(k for r in rows for k in r))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(fields)
        for r in rows:
            w.writerow([_cell(r.get(k)) for k in fields])
    return rows
