"""Google/Flax ViT ``.npz`` pretrained-weight ingestion (counterpart of
``ivit_tpu/compat/flax_npz.py``).

Maps the official ``vision_transformer`` checkpoints (AugReg ViT-B/L) into
the sim's flax-layout tree: the mapping is mostly transpose-free ([in, out]
kernels, HWIO convs); the qkv projection concatenates the query/key/value
kernels on the output axis, and the positional embedding is resized
bicubically when the grids differ (:func:`resize_pos_embed`).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

_F32 = np.float32


def _keys_cubic(x):
    """The Keys cubic kernel with a = -0.5 (``jax.image``'s "bicubic"), in
    f32 operation for operation as JAX evaluates it."""
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= _F32(1.0),
                   ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x + _F32(2.0), out)
    return np.where(x >= _F32(2.0), _F32(0.0), out).astype(_F32)


def resize_weights(m: int, n: int) -> np.ndarray:
    """The [m, n] f32 weight matrix that resamples an axis of ``m`` samples to
    ``n``, as ``jax.image.resize(method="bicubic")`` builds it
    (``scale_and_translate``: half-pixel centres, the kernel widened by the
    scale when downsampling (antialiasing), each column normalised to sum 1,
    columns that sample outside the input zeroed)."""
    inv_scale = _F32(1.0 / (n / m))
    kernel_scale = np.maximum(inv_scale, _F32(1.0))
    sample_f = (np.arange(n, dtype=_F32) + _F32(0.5)) * inv_scale - _F32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=_F32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = np.sum(w, axis=0, keepdims=True, dtype=_F32)
    w = np.where(np.abs(total) > _F32(1000.0 * float(np.finfo(np.float32).eps)),
                 w / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample_f >= _F32(-0.5)) & (sample_f <= _F32(m - 0.5))
    return np.where(inside[None, :], w, _F32(0.0)).astype(_F32)


def resize_pos_embed(posemb: np.ndarray, ntok_new: int,
                     num_tokens: int = 1) -> np.ndarray:
    """Bicubic grid resize of [1, N_old, C] -> [1, ntok_new, C].

    JAX's ``jax.image.resize(..., method="bicubic")``: the same weight
    matrices (:func:`resize_weights`, bitwise), applied one axis at a time
    (rows, then columns) with f32 products; an axis whose size does not
    change is left as it is.  The sums run in BLAS's order, not XLA's, so
    a resized grid agrees with JAX's within f32 rounding of the two
    contractions (``tests/test_torch_port_compat.py`` states the bound); an
    equal grid is returned bitwise.  (``torch.nn.functional.interpolate``'s
    bicubic is another kernel, a = -0.75, with other edges.)
    """
    tok, grid = posemb[:, :num_tokens], posemb[0, num_tokens:]
    gs_old = int(math.sqrt(len(grid)))
    gs_new = int(math.sqrt(ntok_new - num_tokens))
    grid = np.asarray(grid, _F32).reshape(gs_old, gs_old, -1)
    if gs_new != gs_old:
        w = resize_weights(gs_old, gs_new)
        grid = np.tensordot(w, grid, axes=([0], [0]))              # [n, m, C]
        grid = np.tensordot(grid, w, axes=([1], [0])).transpose(0, 2, 1)
    grid = grid.reshape(1, gs_new * gs_new, -1)
    return np.concatenate([tok, grid], axis=1)


def convert_npz(npz, depth: int, num_patches: int,
                prefix: str = "") -> Dict[str, dict]:
    """npz mapping -> the VisionTransformer params subtree (numpy)."""
    w = dict(npz)
    if not prefix and "opt/target/embedding/kernel" in w:
        prefix = "opt/target/"

    def g(name):
        return np.asarray(w[prefix + name], np.float32)

    params: Dict[str, dict] = {}
    params["patch_embed"] = {"proj": {
        "kernel": g("embedding/kernel"),          # [kh,kw,cin,D] HWIO direct
        "bias": g("embedding/bias"),
    }}
    params["cls_token"] = g("cls")
    pos = g("Transformer/posembed_input/pos_embedding")
    if pos.shape[1] != num_patches + 1:
        pos = resize_pos_embed(pos, num_patches + 1)
    params["pos_embed"] = pos
    params["norm"] = {"weight": g("Transformer/encoder_norm/scale"),
                      "bias": g("Transformer/encoder_norm/bias")}
    if prefix + "head/kernel" in w:
        params["head"] = {"kernel": g("head/kernel"),
                          "bias": g("head/bias")}

    for i in range(depth):
        bp = f"Transformer/encoderblock_{i}/"
        mha = bp + "MultiHeadDotProductAttention_1/"
        c = g(mha + "query/kernel").shape[0]
        qkv_kernel = np.concatenate(
            [g(mha + f"{n}/kernel").reshape(c, -1)
             for n in ("query", "key", "value")], axis=1)   # [C, 3C]
        qkv_bias = np.concatenate(
            [g(mha + f"{n}/bias").reshape(-1)
             for n in ("query", "key", "value")])
        out_kernel = g(mha + "out/kernel").reshape(-1, c)    # [(H*Dh), C]
        params[f"blocks_{i}"] = {
            "norm1": {"weight": g(bp + "LayerNorm_0/scale"),
                      "bias": g(bp + "LayerNorm_0/bias")},
            "norm2": {"weight": g(bp + "LayerNorm_2/scale"),
                      "bias": g(bp + "LayerNorm_2/bias")},
            "attn": {
                "qkv": {"kernel": qkv_kernel, "bias": qkv_bias},
                "proj": {"kernel": out_kernel,
                         "bias": g(mha + "out/bias")},
            },
            "mlp": {
                "fc1": {"kernel": g(bp + "MlpBlock_3/Dense_0/kernel"),
                        "bias": g(bp + "MlpBlock_3/Dense_0/bias")},
                "fc2": {"kernel": g(bp + "MlpBlock_3/Dense_1/kernel"),
                        "bias": g(bp + "MlpBlock_3/Dense_1/bias")},
            },
        }
    return params


def load_npz_into_model(model, path: str, strict: bool = True):
    """Load a Google ViT .npz into the ViT sim ``model``, in place (a float
    pretrained start for QAT: the quant_stats keep the sim's values).
    Returns ``(variables, {"matched", "missing"})``; ``strict`` raises,
    before anything is written, if a leaf other than the head's is
    missing (a feature-extractor npz has no head)."""
    from ..models.convert import variables_to_torch
    from .torch_ckpt import _merge_into, template_of

    npz = np.load(path)
    params_in = convert_npz(npz, model.depth, model.num_patches
                            if hasattr(model, "num_patches")
                            else (model.img_size // model.patch_size) ** 2)
    template = template_of(model)
    params, matched, missing = _merge_into(template["params"], params_in)
    if strict:
        missing = [m for m in missing if not m.startswith("head")]
        if missing:
            raise ValueError(f"npz missing leaves: {missing}")
    variables = {"params": params, "quant_stats": template["quant_stats"]}
    variables_to_torch(model, variables)
    return variables, {"matched": matched, "missing": missing}
