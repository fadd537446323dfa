"""The QAT trainer's configuration and parts (counterpart of
``ivit_tpu/train/trainer.py``), without its image pipeline: the config, the
model and optimizer builders, the weight-decay mask, the model EMA and the
calibrate-then-refit sequence over batches the caller passes.

The recipe is the reference's (quant_train.py:246-658): calibration
(forward-only EMA settling) -> ranges frozen for ``calibration_epochs`` ->
AdamW + cosine schedule with warmup (min_lr = lr/15, :391) -> gradient
accumulation to an effective batch size, gradient clipping, model EMA.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from ..models import str2model
from ..models.model_utils import freeze_model as refit_ppoly
from ..models.vit import BitWidths
from . import optim
from .steps import make_calibration_step


@dataclasses.dataclass
class TrainConfig:
    """Reference CLI surface (quant_train.py:31-186): the JAX trainer's
    fields that the ported parts read (the data pipeline's, the loop's and
    the mesh's come with them, ROADMAP Queue 1 items 3-4)."""

    model: str = "deit_tiny_patch16_224"
    gelu_type: str = "ivit"
    softmax_type: str = "ivit"
    layernorm_type: str = "ivit"
    bitwidth: str = "8"

    epochs: int = 90
    batch_size: int = 128
    eff_batch_size: Optional[int] = None      # grad accumulation target
    lr: float = 5e-7
    min_lr_div: float = 15.0                  # min_lr = lr / 15 (ref :391)
    warmup_epochs: int = 0
    warmup_lr: float = 1e-7
    weight_decay: float = 0.0
    clip_grad: Optional[float] = None
    model_ema_decay: float = 0.99996

    img_size: int = 224
    num_classes: int = 1000
    seed: int = 0

    def model_config(self) -> dict:
        bw = BitWidths.from_spec(self.bitwidth)
        return {
            "model": self.model,
            "gelu_type": self.gelu_type,
            "softmax_type": self.softmax_type,
            "layernorm_type": self.layernorm_type,
            "patch_embed_bitwidth": bw.patch_embed,
            "pos_encoding_bitwidth": bw.pos_encoding,
            "block_input_bitwidth": bw.block_input,
            "attention_out_bitwidth": bw.attention_out,
            "softmax_bitwidth": bw.softmax,
            "mlp_out_bitwidth": bw.mlp_out,
            "norm2_in_bitwidth": bw.norm2_in,
            "att_block_out_bitwidth": bw.att_block_out,
        }


def build_model(cfg: TrainConfig, device=None, **overrides):
    """The config's QAT sim, seeded with ``cfg.seed``, on ``device``
    (default ``cuda``); ``overrides`` (``depth=``, ``depths=``,
    ``drop_path_rate=``, ...) go to the factory.  The Swin sims take no
    bitwidth vector (their residual stream is 16-bit)."""
    kw = dict(gelu_type=cfg.gelu_type, softmax_type=cfg.softmax_type,
              layernorm_type=cfg.layernorm_type, img_size=cfg.img_size,
              num_classes=cfg.num_classes, device=device, seed=cfg.seed)
    if not cfg.model.startswith("swin"):
        kw["bitwidths"] = BitWidths.from_spec(cfg.bitwidth)
    return str2model(cfg.model)(**{**kw, **overrides})


# Parameter names timm's ViT/Swin `no_weight_decay()` exempts (in addition
# to every 1-d tensor): learned embeddings and the Swin rel-pos table.
_NO_DECAY_NAMES = ("cls_token", "pos_embed", "relative_position_bias_table")


def weight_decay_mask(params, _names=frozenset()):
    """True where AdamW should apply weight decay.

    Mirrors timm's ``create_optimizer`` parameter groups (the reference
    builds its optimizer through it, quant_train.py:392): decay only
    multi-dimensional kernels -- never biases, norm scales (any 1-d leaf),
    nor the named embedding tables.
    """
    if isinstance(params, dict):
        return {k: weight_decay_mask(v, _names | {k}) for k, v in params.items()}
    if _names & set(_NO_DECAY_NAMES):
        return False
    return params.ndim > 1


def build_optimizer(cfg: TrainConfig, steps_per_epoch: int):
    """AdamW + cosine decay to lr/15 with linear warmup + optional clip,
    wrapped in MultiSteps for gradient accumulation (ref :581-587,616-631);
    returns ``(tx, schedule, accum)``."""
    accum = max(1, (cfg.eff_batch_size or cfg.batch_size) // cfg.batch_size)
    schedule = optim.warmup_cosine_decay_schedule(
        init_value=cfg.warmup_lr if cfg.warmup_epochs else cfg.lr,
        peak_value=cfg.lr,
        warmup_steps=cfg.warmup_epochs * steps_per_epoch // accum,
        decay_steps=max(1, cfg.epochs * steps_per_epoch // accum),
        end_value=cfg.lr / cfg.min_lr_div)
    chain = []
    if cfg.clip_grad:
        chain.append(optim.clip_by_global_norm(cfg.clip_grad))
    chain.append(optim.adamw(schedule, weight_decay=cfg.weight_decay,
                             mask=weight_decay_mask))
    tx = optim.chain(*chain)
    if accum > 1:
        tx = optim.MultiSteps(tx, every_k_schedule=accum)
    return tx, schedule, accum


def init_ema(params):
    """The model EMA's first value: a copy of the parameters."""
    return optim.tree_map(lambda p: p.detach().clone(), params)


def update_ema(ema_params, params, decay: float):
    """``e * d + (1 - d) * p`` on each leaf, in place (``train_epoch``
    :311-315); returns ``ema_params``."""
    d, c = float(optim.f32(decay)), float(optim.f32(1 - decay))
    with torch.no_grad():
        optim.tree_map(lambda e, p: e.mul_(d).add_(p * c), ema_params, params)
    return ema_params


def calibrate(model, batches: Iterable):
    """Forward-only range settling over ``batches`` (NHWC image batches;
    ref calibrate_model :199-244), then the ppoly tables refit from the
    ranges (``_refit_ppoly``: ``models.model_utils.freeze_model``)."""
    step = make_calibration_step(model)
    for images in batches:
        step(images)
    refit_ppoly(model)
