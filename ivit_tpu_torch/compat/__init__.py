"""Checkpoint interop of the port (counterpart of ``ivit_tpu/compat``): the
reference I-ViT's ``.pth.tar`` both ways, timm/DeiT float ``.pth`` and
Google ViT ``.npz`` files into the QAT sims."""
