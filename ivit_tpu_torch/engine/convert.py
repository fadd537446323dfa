"""Weights carried across from the JAX package.

The JAX engine's parameter tree, fetched as numpy arrays
(``jax.device_get(spec.params)`` or an ``.npz`` artifact), becomes the
port's tree of tensors: the same dict/list nesting, the same keys, the
same dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32}


def params_to_torch(params_np, device):
    """Numpy (or array-like) parameter tree -> tensors on ``device``.

    Leaves keep their dtype; the engine's trees hold only int8, int32 and
    f32, and any other dtype raises.  Tensors already in the tree are moved
    as they are.
    """
    if isinstance(params_np, dict):
        return {k: params_to_torch(v, device) for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return [params_to_torch(v, device) for v in params_np]
    if isinstance(params_np, torch.Tensor):
        return params_np.to(device)
    arr = np.asarray(params_np)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"engine parameter of dtype {arr.dtype}; the engine "
                        "holds only int8, int32 and float32 leaves")
    # a writable C-contiguous copy: the kernels take contiguous operands
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def params_to_numpy(params):
    """The inverse of :func:`params_to_torch`: a tree of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return np.asarray(params)
