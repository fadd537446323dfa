"""QAT train, eval and calibration steps (counterpart of
``ivit_tpu/train/steps.py``).

The steps are plain functions over the port's sims
(:class:`~ivit_tpu_torch.models.vit.VisionTransformer`,
:class:`~ivit_tpu_torch.models.swin.SwinTransformer`).  The state is a dict
as JAX's: ``params`` and ``quant_stats`` are the module's own parameters and
range buffers in the flax layout (``models/convert.py::variables_tree``),
``opt_state`` the optimizer's (``train/optim.py``), ``step`` an int32
count; a step updates them in place and returns the same dict.  Dropout
and drop-path draw from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..models.convert import variables_tree
from ..models.layers import exact_f32
from .distill import distillation_loss
from .optim import apply_updates, global_norm, tree_map


def cross_entropy(logits, targets, num_classes: int):
    """CE against int labels or soft (mixup) target rows."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if targets.ndim == logits.ndim:                  # soft targets
        return -torch.mean(torch.sum(targets * logp, dim=-1))
    onehot = F.one_hot(targets.long(), num_classes).to(logp.dtype)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def _batch(model, batch):
    """The batch on the model's device; soft targets in f32, as
    ``jnp.asarray`` makes them (numpy's CutMix targets are f64)."""
    dev = model.device
    image = torch.as_tensor(batch["image"], dtype=torch.float32, device=dev)
    label = torch.as_tensor(batch["label"], device=dev)
    if label.is_floating_point():
        label = label.float()
    return image, label


def make_train_step(model, tx, num_classes: int, running_stat: bool = True, *,
                    log_grad_norm: bool = False,
                    teacher_fn: Optional[Callable] = None,
                    distillation_type: str = "none", alpha: float = 0.5,
                    tau: float = 1.0):
    """Returns ``step(state, batch, generator=None, running_stat=None) ->
    (state, metrics)``.

    ``state``: :func:`init_train_state`'s dict; ``batch``: dict(image
    [B, H, W, 3] f32, label [B] int or [B, C] soft).  The forward runs with
    ``train=True`` (dropout and drop-path from ``generator``) and
    ``running_stat`` (the factory's unless the call passes one: the
    trainer freezes the ranges for its calibration epochs), then
    ``backward`` with TF32 off, then the update under ``torch.no_grad()``.
    With ``teacher_fn`` the loss takes :func:`distillation_loss`'s term.
    ``metrics``: loss and acc (and the gradients' global norm with
    ``log_grad_norm``), as tensors.
    """

    default_running_stat = running_stat

    def step(state: Dict[str, Any], batch, generator=None, running_stat=None):
        rs = default_running_stat if running_stat is None else running_stat
        params = state["params"]
        for p in model.parameters():
            p.grad = None
        image, label = _batch(model, batch)
        with exact_f32():
            logits = model(image, running_stat=rs, train=True, generator=generator)
            loss = cross_entropy(logits, label, num_classes)
            if teacher_fn is not None:
                loss = distillation_loss(loss, logits, teacher_fn(image),
                                         distillation_type, alpha, tau)
            loss.backward()
        # a parameter the graph does not reach (an LN bias behind a detached
        # path) has the zero gradient jax.grad gives it
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                         params)
        with torch.no_grad():
            updates, state["opt_state"] = tx.update(grads, state["opt_state"], params)
            apply_updates(params, updates)
        state["step"] = state["step"] + 1
        hard = label.argmax(-1) if label.ndim == 2 else label
        metrics = {"loss": loss.detach(),
                   "acc": torch.mean((logits.detach().argmax(-1) == hard).float())}
        if log_grad_norm:
            metrics["grad_norm"] = global_norm(grads)
        return state, metrics

    return step


def top5_correct(logits, label):
    """Whether ``label`` is among the five largest logits, ties broken to
    the lower index as ``jax.lax.top_k`` breaks them."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :5]
    return torch.any(order == label[:, None], dim=-1)


def make_eval_step(model, num_classes: int):
    """Returns ``step(batch) -> metrics`` of the frozen sim
    (``running_stat=False``): loss, top1, top5 and count."""

    def step(batch):
        image, label = _batch(model, batch)
        with torch.no_grad():
            logits = model(image, running_stat=False)
        loss = cross_entropy(logits, label, num_classes)
        top1 = (logits.argmax(-1) == label).float()
        top5 = top5_correct(logits, label).float()
        return {"loss": loss, "top1": torch.mean(top1), "top5": torch.mean(top5),
                "count": torch.tensor(float(label.shape[0]))}

    return step


def make_calibration_step(model):
    """Returns ``step(images) -> quant_stats``: a forward-only range update
    (ref calibrate_model, quant_train:199) of the module's buffers."""

    def step(images):
        with torch.no_grad():
            model(torch.as_tensor(images, dtype=torch.float32, device=model.device),
                  running_stat=True)
        return variables_tree(model)["quant_stats"]

    return step


def init_train_state(model, tx) -> Dict[str, Any]:
    """The state of a built (seeded) sim: its parameters and ranges, the
    optimizer's state for them, step 0."""
    variables = variables_tree(model)
    return {"params": variables["params"],
            "quant_stats": variables["quant_stats"],
            "opt_state": tx.init(variables["params"]),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}
