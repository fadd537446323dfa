"""Frozen-engine artifact: ``.npz`` parameter tree + ``.json`` config
(counterpart of ``ivit_tpu/engine/export.py``; the same file format, so an
artifact saved by either package loads in the other)."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .. import resolve_device
from ..models.vit import BitWidths
from .convert import params_to_numpy, params_to_torch
from .freeze import EngineConfig, EngineSpec
from .swin_int import SwinEngineConfig, SwinEngineSpec


def _flatten(tree, prefix=""):
    """``a/b/0/c`` keys, each dict's in sorted order: the order JAX's
    ``save_engine`` writes (its ``jax.device_get`` sorts a pytree's dict
    keys), so that both packages save the same bytes."""
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_engine(spec, path: str):
    """Save a ViT or Swin engine spec as ``.npz`` + ``.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(_base(path) + ".npz",
                        **_flatten(params_to_numpy(spec.params)))
    cfg = dataclasses.asdict(spec.config)
    cfg["bitwidths"] = spec.config.bitwidths.to_list()
    with open(_base(path) + ".json", "w") as f:
        json.dump(cfg, f, indent=2)


def load_engine(path: str, device=None):
    """Load a ViT (``EngineSpec``) or Swin (``SwinEngineSpec``) engine
    artifact with its tensors on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    base = _base(path)
    with open(base + ".json") as f:
        cfg = json.load(f)
    cfg["bitwidths"] = BitWidths(*cfg["bitwidths"])
    if "layout" in cfg:
        # Swin artifact: restore the static tuples JSON turned into lists
        cfg["depths"] = tuple(cfg["depths"])
        cfg["stage_heads"] = tuple(cfg["stage_heads"])
        cfg["layout"] = tuple(tuple(e) for e in cfg["layout"])
        config, spec_cls = SwinEngineConfig(**cfg), SwinEngineSpec
    else:
        config, spec_cls = EngineConfig(**cfg), EngineSpec
    with np.load(base + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    return spec_cls(config=config, params=params_to_torch(_unflatten(flat), dev))
