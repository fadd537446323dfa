"""Piecewise execution of the QAT sim (counterpart of
``ivit_tpu/models/chunked.py``).

JAX runs its sims in pieces (a ``lax.scan`` over the ViT blocks, one small
jit per Swin block and merge) to keep each XLA module small.  Eager
PyTorch compiles nothing, so each function here is a plain loop over the
model's submodules with JAX's contract: bitwise equal to the model's
forward, dropout and drop-path off, and under ``running_stat`` the
return ``(logits, {"quant_stats": tree})``, the updated ranges as the flax
tree of numpy arrays (``models/convert.py``); the model's buffers are
updated in place, as its forward updates them.
"""

from __future__ import annotations

import torch

from .convert import variables_to_numpy
from .layers import exact_f32


def _run(model, x, running_stat, blocks):
    x = torch.as_tensor(x, dtype=torch.float32, device=model.device)
    with exact_f32():
        x, s = model.embed(x, running_stat=running_stat)
        for mod in blocks:
            x, s = mod(x, s, running_stat=running_stat)
        logits = model.tail(x, s, running_stat=running_stat)
    if running_stat:
        return logits, {"quant_stats": variables_to_numpy(model)["quant_stats"]}
    return logits


def scan_apply(model, x, *, running_stat: bool = False):
    """A :class:`~ivit_tpu_torch.models.vit.VisionTransformer` forward as
    the embedding, a loop over its blocks and the tail (``chunked.py:54``)."""
    return _run(model, x, running_stat, list(model.blocks))


def swin_chunked_apply(model, x, *, running_stat: bool = False):
    """A :class:`~ivit_tpu_torch.models.swin.SwinTransformer` forward as
    the embedding, each block and merge in turn, and the tail
    (``chunked.py:137``)."""
    pieces = [m for blocks, merge in model.stages
              for m in blocks + ([merge] if merge is not None else [])]
    return _run(model, x, running_stat, pieces)
