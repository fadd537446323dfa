"""DeiT distillation loss (counterpart of ``ivit_tpu/train/distill.py``; ref
``utils/train_utils.py:6-66``): hard or soft distillation from a float
teacher, typically :class:`~ivit_tpu_torch.models.vit_float.FloatVisionTransformer`,
for DeiT-style QAT fine-tuning.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def distillation_loss(base_loss, student_logits, teacher_logits,
                      distillation_type: str = "none",
                      alpha: float = 0.5, tau: float = 1.0):
    """Combine the base criterion with a distillation term.

    ``soft``: KL(teacher || student) at temperature tau (scaled by tau^2);
    ``hard``: CE against the teacher's argmax -- matching train_utils.py:40-62.
    """
    if distillation_type == "none" or teacher_logits is None:
        return base_loss
    if distillation_type == "soft":
        t = F.log_softmax(teacher_logits / tau, dim=-1)
        s = F.log_softmax(student_logits / tau, dim=-1)
        distill = torch.mean(torch.sum(torch.exp(t) * (t - s), dim=-1)) * tau * tau
    elif distillation_type == "hard":
        hard_targets = torch.argmax(teacher_logits, dim=-1)
        logp = F.log_softmax(student_logits, dim=-1)
        distill = -torch.mean(torch.gather(logp, -1, hard_targets[:, None]))
    else:
        raise ValueError(f"unknown distillation type {distillation_type!r}")
    return base_loss * (1 - alpha) + distill * alpha


def make_teacher_fn(teacher_model, device=None) -> Callable:
    """The frozen teacher's forward: its parameters stop taking gradients,
    the model moves to ``device`` (the student's; default: where it is),
    and each call runs under ``torch.no_grad()`` on the student's images."""
    if device is not None:
        teacher_model.to(device)
    for p in teacher_model.parameters():
        p.requires_grad_(False)
    teacher_model.eval()

    def teacher_fn(images):
        with torch.no_grad():
            dev = next(teacher_model.parameters()).device
            return teacher_model(images.to(dev)).float()

    return teacher_fn
