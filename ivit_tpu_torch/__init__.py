"""PyTorch/CUDA port of the ``ivit_tpu`` integer-only ViT engine.

A second package beside the JAX reference: it imports ``torch`` and
``numpy`` only, keeps its own copies of the pieces it needs, and is held
bit-exact against the JAX package by ``tests/test_torch_port_*.py``.

Entry points (:class:`~ivit_tpu_torch.engine.vit_int.Engine`,
:func:`~ivit_tpu_torch.engine.vit_int.engine_forward`,
:func:`~ivit_tpu_torch.engine.export.load_engine`,
:class:`~ivit_tpu_torch.engine.serving.ServingEngine`, the QAT sims
:class:`~ivit_tpu_torch.models.vit.VisionTransformer` and
:class:`~ivit_tpu_torch.models.swin.SwinTransformer` and their factories)
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present -- the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ivit_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
