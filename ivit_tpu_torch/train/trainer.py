"""QAT trainer (counterpart of ``ivit_tpu/train/trainer.py``).

Reproduces the reference training recipe (quant_train.py:246-658):
calibration (forward-only EMA settling) -> ranges frozen for
``calibration_epochs`` -> unfix -> AdamW + cosine schedule with warmup
(min_lr = lr/15, :391) -> gradient accumulation to an effective batch size,
gradient clipping, model EMA, mixup/cutmix with label smoothing -> per-epoch
checkpoint + best tracking -> resume with full optimizer/schedule state.

As in JAX: the JSONL logger replaces W&B with the same fields; ppoly tables
are refit from the tracked ranges after calibration and at every epoch
boundary.  The port has no mesh (``mesh_dp`` / ``mesh_tp``, ROADMAP Queue 1
item 4).  Each step's dropout and drop-path draw from a CPU
``torch.Generator`` seeded with JAX's fold ``epoch * 100003 + i``; the
draws cannot be JAX's PRNG bits (DeiT's drop rates are 0).
"""

from __future__ import annotations

import dataclasses
import logging
import time
import uuid
from typing import Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import str2model
from ..models.model_utils import freeze_model as refit_ppoly
from ..models.vit import BitWidths
from ..utils.metrics import AverageMeter, JsonlLogger, ProgressMeter
from . import checkpoint as ckpt_io
from . import optim
from .data import Mixup, data_loader
from .randaug import parse_rand_augment
from .steps import (init_train_state, make_calibration_step, make_eval_step,
                    make_train_step)

log = logging.getLogger("ivit_tpu_torch.train")


@dataclasses.dataclass
class TrainConfig:
    """Reference CLI surface (quant_train.py:31-186), trimmed to the knobs
    that affect training semantics: JAX's fields less ``mesh_dp`` /
    ``mesh_tp`` (ROADMAP Queue 1 item 4)."""

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
    model_ema: bool = False
    model_ema_decay: float = 0.99996

    calibration_batches: int = 10
    calibration_epochs: int = 0

    mixup: float = 0.8
    cutmix: float = 1.0
    smoothing: float = 0.1
    aa: Optional[str] = "rand-m9-mstd0.5-inc1"  # ref quant_train.py:117
    img_size: int = 224
    num_classes: int = 1000

    seed: int = 0
    output_dir: str = "runs"
    run_id: str = ""
    resume: Optional[str] = None
    log_interval: int = 50
    log_grad_norm: bool = False            # wandb.watch-style gradient stats

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


class Trainer:
    """The training loop over an image dataset (JAX's ``Trainer`` less the
    mesh): ``fit()`` calibrates, trains ``cfg.epochs`` epochs, validates,
    logs and checkpoints each; ``device`` (default ``cuda``) holds the sim,
    the optimizer state and the EMA."""

    def __init__(self, cfg: TrainConfig, dataset_train, dataset_val, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)
        self.ds_train = dataset_train
        self.ds_val = dataset_val
        self.run_id = cfg.run_id or uuid.uuid4().hex[:8]
        self.logger = JsonlLogger(
            f"{cfg.output_dir}/log_{self.run_id}.jsonl", self.run_id)
        self.mixup_fn = (Mixup(cfg.mixup, cfg.cutmix,
                               label_smoothing=cfg.smoothing,
                               num_classes=cfg.num_classes)
                         if cfg.mixup > 0 or cfg.cutmix > 0 else None)
        self.steps_per_epoch = max(1, len(dataset_train) // cfg.batch_size)
        self.tx, self.schedule, self.accum = build_optimizer(
            cfg, self.steps_per_epoch)
        self.rng = np.random.default_rng(cfg.seed)
        self.rand_augment = parse_rand_augment(cfg.aa)

        self.state = init_train_state(self.model, self.tx)
        self.ema_params = init_ema(self.state["params"]) if cfg.model_ema else None
        self.best_acc1 = 0.0
        self.start_epoch = 0

        self._train_step = make_train_step(self.model, self.tx, cfg.num_classes,
                                           log_grad_norm=cfg.log_grad_norm)
        self._eval_step = make_eval_step(self.model, cfg.num_classes)
        self._calib_step = make_calibration_step(self.model)

        if cfg.resume:
            self._resume(cfg.resume)

    # -- lifecycle ----------------------------------------------------------

    def calibrate(self):
        """Forward-only EMA range settling (ref calibrate_model :199-244)."""
        cfg = self.cfg
        log.info("calibrating on %d batches", cfg.calibration_batches)
        it = data_loader(self.ds_train, cfg.batch_size, train=True,
                         img_size=cfg.img_size, seed=cfg.seed + 999,
                         rand_augment=self.rand_augment)
        prev_scale = None
        for i, batch in enumerate(it):
            if i >= cfg.calibration_batches:
                break
            qs = self._calib_step(batch["image"])
            scale = float(qs["qact_input"]["act_scaling_factor"].reshape(-1)[0])
            if prev_scale:
                log.info("calib %d: input scale %.6g (drift %.3g)",
                         i, scale, abs(scale - prev_scale) / prev_scale)
            prev_scale = scale
        self._refit_ppoly()

    def _refit_ppoly(self):
        refit_ppoly(self.model)          # a no-op without ppoly sites

    def train_epoch(self, epoch: int):
        cfg = self.cfg
        # ranges frozen until calibration_epochs, then unfixed (ref :454-459)
        running_stat = epoch >= cfg.calibration_epochs
        meters = {k: AverageMeter(k, ":.4f") for k in
                  ("loss", "acc", "time")}
        progress = ProgressMeter(
            self.steps_per_epoch,
            list(meters.values()), prefix=f"Epoch[{epoch}]")
        it = data_loader(self.ds_train, cfg.batch_size, train=True,
                         img_size=cfg.img_size, seed=cfg.seed + epoch,
                         rand_augment=self.rand_augment)
        t0 = time.time()
        for i, batch in enumerate(it):
            images, labels = batch["image"], batch["label"]
            if self.mixup_fn is not None:
                images, labels = self.mixup_fn(images, labels, self.rng)
            self.state, metrics = self._train_step(
                self.state, {"image": images, "label": labels},
                torch.Generator().manual_seed(epoch * 100003 + i),
                running_stat)
            if self.ema_params is not None:
                update_ema(self.ema_params, self.state["params"],
                           cfg.model_ema_decay)
            dt = time.time() - t0
            t0 = time.time()
            meters["loss"].update(float(metrics["loss"]))
            meters["acc"].update(float(metrics["acc"]))
            meters["time"].update(dt)
            if i % cfg.log_interval == 0:
                progress.display(i)
                self.logger.log({"phase": "train", "epoch": epoch,
                                 "loss": float(metrics["loss"]),
                                 "acc": float(metrics["acc"])},
                                step=int(self.state["step"]))
        return meters["loss"].avg

    def validate(self):
        cfg = self.cfg
        totals = {"loss": 0.0, "top1": 0.0, "top5": 0.0, "n": 0}
        it = data_loader(self.ds_val, cfg.batch_size, train=False,
                         img_size=cfg.img_size, drop_last=True)
        for batch in it:
            m = self._eval_step(batch)
            n = int(m["count"])
            totals["n"] += n
            for k in ("loss", "top1", "top5"):
                totals[k] += float(m[k]) * n
        n = max(1, totals["n"])
        return {k: totals[k] / n for k in ("loss", "top1", "top5")}

    def fit(self):
        cfg = self.cfg
        if cfg.calibration_batches and self.start_epoch == 0:
            self.calibrate()
        t_start = time.time()
        for epoch in range(self.start_epoch, cfg.epochs):
            train_loss = self.train_epoch(epoch)
            self._refit_ppoly()
            val = self.validate()
            is_best = val["top1"] > self.best_acc1
            self.best_acc1 = max(self.best_acc1, val["top1"])
            elapsed = time.time() - t_start
            eta = elapsed / (epoch - self.start_epoch + 1) * \
                (cfg.epochs - epoch - 1)
            log.info("epoch %d: loss %.4f top1 %.4f top5 %.4f best %.4f "
                     "eta %.0fs", epoch, train_loss, val["top1"],
                     val["top5"], self.best_acc1, eta)
            self.logger.log({"phase": "epoch", "epoch": epoch,
                             "train_loss": train_loss, **val,
                             "best_acc1": self.best_acc1, "eta_s": eta})
            ckpt_io.save_checkpoint(
                f"{cfg.output_dir}/checkpoint_{self.run_id}",
                self.state, epoch=epoch, best_acc1=self.best_acc1,
                model_config=cfg.model_config(),
                args=dataclasses.asdict(cfg),
                ema_params=self.ema_params, is_best=is_best)
        return self.best_acc1

    # -- resume -------------------------------------------------------------

    def _resume(self, path: str):
        template = dict(self.state)
        if self.ema_params is not None:
            template["ema_params"] = self.ema_params
        state, meta = ckpt_io.load_checkpoint(path, template)
        self.ema_params = state.pop("ema_params", self.ema_params)
        self.state = state
        self.start_epoch = meta["epoch"] + 1
        self.best_acc1 = meta["best_acc1"]
        log.info("resumed from %s at epoch %d (best %.4f)", path,
                 self.start_epoch, self.best_acc1)
