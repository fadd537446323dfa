"""Checkpoint save/load (counterpart of ``ivit_tpu/train/checkpoint.py``;
ref quant_train.py:466-500, 405-443).

Format, the JAX package's: a directory with ``state.msgpack`` (the flax
msgpack encoding of the variables, the optimizer state, the step and the
EMA, ``train/serialization.py``) and ``meta.json`` (epoch, best_acc1,
model_config, args, keys).  The state dict is laid out as the JAX trainer
writes it: top-level keys sorted, ``params`` / ``quant_stats`` /
``ema_params`` trees in sorted key order (``jax.device_get``), the
optimizer state as flax's ``to_state_dict`` of optax's
(``train/optim.py``).  So a JAX checkpoint loads into the port's state and
the port's into JAX's ``load_variables`` / ``load_checkpoint``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .optim import tree_map
from .serialization import msgpack_restore, to_bytes


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                    else t, tree)


def _sorted(tree):
    if not isinstance(tree, dict):
        return tree
    return {k: _sorted(tree[k]) for k in sorted(tree)}


def state_dict(state: Dict[str, Any], ema_params=None) -> dict:
    """The state as the JAX trainer's ``to_state_dict(jax.device_get(...))``:
    numpy leaves, the keys in its order."""
    payload = dict(state)
    if ema_params is not None:
        payload["ema_params"] = ema_params
    out = {}
    for k in sorted(payload):
        v = _numpy(payload[k])
        out[k] = v if k == "opt_state" else _sorted(v)
    return out


def save_checkpoint(path: str, state: Dict[str, Any], *, epoch: int,
                    best_acc1: float, model_config: dict,
                    args: Optional[dict] = None,
                    ema_params=None, is_best: bool = False):
    os.makedirs(path, exist_ok=True)
    payload = state_dict(state, ema_params)
    blob = to_bytes(payload)
    with open(os.path.join(path, "state.msgpack"), "wb") as f:
        f.write(blob)
    meta = {"epoch": int(epoch), "best_acc1": float(best_acc1),
            "model_config": model_config, "args": args or {},
            "keys": sorted(payload.keys())}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    if is_best:
        best = os.path.join(os.path.dirname(path.rstrip("/")), "best")
        os.makedirs(best, exist_ok=True)
        with open(os.path.join(best, "state.msgpack"), "wb") as f:
            f.write(blob)
        with open(os.path.join(best, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)


def _restore(template, raw, path: str):
    """Copy ``raw`` (numpy leaves) into ``template``'s tensors, in place,
    checking the structure, shapes and dtypes as flax's ``from_state_dict``
    checks the structure."""
    if isinstance(template, dict):
        if not isinstance(raw, dict) or set(raw) != set(template):
            got = sorted(raw) if isinstance(raw, dict) else type(raw).__name__
            raise ValueError(f"checkpoint keys {got} != the state's {sorted(template)} "
                             f"at {path or '/'}")
        for k in template:
            _restore(template[k], raw[k], f"{path}/{k}")
        return template
    arr = np.asarray(raw)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()
    src = torch.from_numpy(arr)
    if tuple(src.shape) != tuple(template.shape) or src.dtype != template.dtype:
        raise ValueError(f"{path}: checkpoint {arr.dtype}{list(arr.shape)} != the "
                         f"state's {template.dtype}{list(template.shape)}")
    with torch.no_grad():
        template.copy_(src)
    return template


def load_checkpoint(path: str, template: Dict[str, Any]):
    """Restore into ``template`` (the port's state, :func:`~ivit_tpu_torch.
    train.steps.init_train_state`: the module's own parameters and buffers,
    so the module is loaded), in place; returns ``(state, meta)``.  Where
    the checkpoint holds ``ema_params`` and the template does not, the
    state gains a copy of the params to restore it into, as JAX's does."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        raw = msgpack_restore(f.read())
    state = dict(template)
    if "ema_params" in meta.get("keys", []) and "ema_params" not in state:
        state["ema_params"] = tree_map(lambda p: p.detach().clone(), state["params"])
    _restore(state, raw, "")
    return state, meta


def load_variables(path: str):
    """Structure-free restore of just the model variables, as numpy trees
    (for inference: ``models/convert.py::variables_to_torch`` puts them in
    a sim; the optimizer-state layout depends on the training config)."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        raw = msgpack_restore(f.read())
    return {"params": raw["params"], "quant_stats": raw["quant_stats"]}


def load_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)
