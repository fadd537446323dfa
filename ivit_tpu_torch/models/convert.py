"""The QAT sim's variables carried across from and to the JAX package.

A flax ``{"params", "quant_stats"}`` tree of numpy arrays (``jax.device_get``
of ``model.init`` / ``model.apply`` output) maps leaf for leaf onto the
module: its parameters are ``params``, its buffers ``quant_stats``, in the
JAX layouts (linear kernels ``[in, out]``, conv kernels HWIO), under the
same names; flax's ``blocks_<i>`` is the module list's ``blocks.<i>``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK = re.compile(r"^blocks_(\d+)$")


def _torch_name(path):
    """flax key path -> the module's dotted name."""
    return ".".join(_BLOCK.sub(r"blocks.\1", k) for k in path)


def _flax_path(name):
    """The module's dotted name -> flax key path."""
    parts, out, i = name.split("."), [], 0
    while i < len(parts):
        if parts[i] == "blocks" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"blocks_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return tuple(out)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def variables_to_torch(model, variables_np):
    """Copy a flax variable tree (numpy leaves) into ``model``'s parameters
    and buffers, in place; returns ``model``.  Every leaf must have its
    tensor, of the same shape, and every tensor its leaf."""
    kinds = {"params": dict(model.named_parameters()),
             "quant_stats": dict(model.named_buffers())}
    seen = set()
    with torch.no_grad():
        for coll, tensors in kinds.items():
            for path, leaf in _leaves(variables_np.get(coll, {})):
                name = _torch_name(path)
                if name not in tensors:
                    raise KeyError(f"{coll} leaf {'/'.join(path)} has no tensor "
                                   f"{name!r} in the model")
                t = tensors[name]
                arr = np.asarray(leaf)
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{name}: leaf shape {arr.shape}, tensor "
                                     f"shape {tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.array(arr, dtype=arr.dtype)).to(t.dtype))
                seen.add(name)
    missing = (set(kinds["params"]) | set(kinds["quant_stats"])) - seen
    if missing:
        raise KeyError(f"no leaf for {sorted(missing)}")
    return model


def variables_to_numpy(model) -> dict:
    """The module's parameters and buffers as a flax ``{"params",
    "quant_stats"}`` tree of numpy arrays (the inverse of
    :func:`variables_to_torch`)."""
    out = {"params": {}, "quant_stats": {}}
    for coll, named in (("params", model.named_parameters()),
                        ("quant_stats", model.named_buffers())):
        for name, t in named:
            node = out[coll]
            *path, leaf = _flax_path(name)
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t.detach().cpu().numpy().copy()
    return out


def _sorted(tree):
    return {k: _sorted(tree[k]) if isinstance(tree[k], dict) else tree[k]
            for k in sorted(tree)}


def variables_tree(model) -> dict:
    """The module's parameters and buffers themselves (not copies) as a flax
    ``{"params", "quant_stats"}`` tree, every dict's keys sorted as
    ``jax.device_get`` leaves them: the train step's state
    (``train/steps.py``) updates the module through it."""
    out = {"params": {}, "quant_stats": {}}
    for coll, named in (("params", model.named_parameters()),
                        ("quant_stats", model.named_buffers())):
        for name, t in named:
            node = out[coll]
            *path, leaf = _flax_path(name)
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t
    return _sorted(out)


def differing_leaves(a, b, path=""):
    """The leaf paths where two trees (dicts, lists, arrays or tensors) differ
    in structure, dtype, shape or value; ``[]`` when they are equal leaf for
    leaf (NaNs equal where both have them)."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or set(a) != set(b):
            return [path or "/"]
        return [d for k in a for d in differing_leaves(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) or not isinstance(b, (list, tuple)) \
                or len(a) != len(b):
            return [path or "/"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differing_leaves(x, y, f"{path}/{i}")]
    x, y = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in (a, b))
    if x.dtype != y.dtype or x.shape != y.shape \
            or not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
        return [path]
    return []
