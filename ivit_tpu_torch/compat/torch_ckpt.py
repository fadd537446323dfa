"""Reference (PyTorch) checkpoint ingestion (counterpart of
``ivit_tpu/compat/torch_ckpt.py``).

Reads the QAT checkpoints the reference trainer writes (a dict with the
``model`` state_dict, ``model_config``, optimizer state, ...) and the
timm/DeiT float ``.pth`` files, and converts them into the flax-layout
``{params, quant_stats}`` tree of numpy arrays that the port's sims hold
(``models/convert.py``): the state_dict carries every quantization buffer
(x_min/x_max, scaling factors, LN shift), so a checkpoint fully determines
the integer network.

Name/layout mapping (reference -> flax tree):
  ``blocks.N.``                -> ``blocks_N.``
  ``layers.N.blocks.M.``       -> ``layers_N_blocks_M.`` (Swin)
  ``layers.N.downsample.``     -> ``layers_N_downsample.``
  linear ``weight [O,I]``      -> ``kernel [I,O]`` (transposed)
  conv ``weight [O,I,kh,kw]``  -> ``kernel [kh,kw,I,O]``
  LayerNorm ``weight/bias``    -> same names
  QuantAct buffers x_min/x_max/act_scaling_factor -> quant_stats
  IBERT-LN ``shift``           -> quant_stats
Derived buffers the engine recomputes (weight_integer, bias_integer,
fc_scaling_factor, norm_scaling_factor, dim_sqrt, ...) are dropped.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_DROPPED_SUFFIXES = (
    "weight_integer", "bias_integer", "fc_scaling_factor",
    "conv_scaling_factor", "norm_scaling_factor", "dim_sqrt",
    "input_scaling_factor", "fixed_bounds", "fixed_coeffs",
    "fixed_scaling_factor_out", "num_batches_tracked",
)

_QUANT_STAT_NAMES = ("x_min", "x_max", "act_scaling_factor", "shift",
                     "bounds", "coeffs", "fitted", "x_lo", "x_hi", "in_scale")


def load_torch_checkpoint(path: str):
    """Load a reference ``.pth.tar`` (or a float ``.pth``); returns
    ``(state_dict as numpy, model_config or None)``.

    ``torch.load(weights_only=False)`` unpickles the file, as the reference
    trainer's own loader does (its checkpoints carry the ``model_config``
    dict and optimizer state): load only files you trust.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt.get("state_dict", ckpt))
    state = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
             for k, v in state.items()}
    return state, ckpt.get("model_config")


def _set(tree: dict, path: Tuple[str, ...], value):
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def convert_state_dict(state: Dict[str, np.ndarray]):
    """Reference state_dict -> (params, quant_stats) nested numpy trees."""
    params: dict = {}
    qstats: dict = {}

    for key, value in state.items():
        if any(key.endswith(suf) for suf in _DROPPED_SUFFIXES):
            continue
        parts = key.split(".")
        # blocks.N.rest -> blocks_N.rest
        if parts[0] == "blocks" and len(parts) > 1 and parts[1].isdigit():
            parts = [f"blocks_{parts[1]}"] + parts[2:]
        # swin: layers.N.blocks.M. -> layers_N_blocks_M.,
        #       layers.N.downsample. -> layers_N_downsample.
        elif parts[0] == "layers" and len(parts) > 2 and parts[1].isdigit():
            if parts[2] == "blocks" and len(parts) > 3 and parts[3].isdigit():
                parts = [f"layers_{parts[1]}_blocks_{parts[3]}"] + parts[4:]
            elif parts[2] == "downsample":
                parts = [f"layers_{parts[1]}_downsample"] + parts[3:]
        leaf = parts[-1]
        value = np.asarray(value)

        if leaf in _QUANT_STAT_NAMES:
            _set(qstats, tuple(parts[:-1]) + (leaf,),
                 value.reshape(-1) if leaf in ("x_min", "x_max", "shift",
                                               "act_scaling_factor")
                 and value.ndim == 0 else value)
            continue

        if leaf == "weight":
            if value.ndim == 4:          # conv [O,I,kh,kw] -> [kh,kw,I,O]
                value = value.transpose(2, 3, 1, 0)
                leaf = "kernel"
            elif value.ndim == 2:        # linear [O,I] -> [I,O]
                value = value.T
                leaf = "kernel"
            # LayerNorm 1-D weight keeps its name
        _set(params, tuple(parts[:-1]) + (leaf,), value.astype(np.float32))

    return params, qstats


def _merge_into(template, incoming, path=()):
    """Overlay incoming values onto a template tree (a leaf of the same size
    is reshaped, then cast to the template's dtype); leaves missing from
    incoming keep template values; returns ``(tree, matched, missing)``."""
    matched, missing = [], []
    out = {}
    for key, tval in template.items():
        sub = incoming.get(key) if isinstance(incoming, dict) else None
        if isinstance(tval, dict):
            o, m1, m2 = _merge_into(tval, sub or {}, path + (key,))
            out[key] = o
            matched += m1
            missing += m2
        else:
            if sub is not None:
                arr = np.asarray(sub)
                want = np.asarray(tval)
                if arr.shape != want.shape:
                    if arr.size == want.size:
                        arr = arr.reshape(want.shape)
                    else:
                        raise ValueError(
                            f"shape mismatch at {'.'.join(path + (key,))}: "
                            f"checkpoint {arr.shape} vs model {want.shape}")
                out[key] = arr.astype(want.dtype)
                matched.append(".".join(path + (key,)))
            else:
                out[key] = tval
                missing.append(".".join(path + (key,)))
    return out, matched, missing


def template_of(model) -> dict:
    """The sim's variables as the merge template: its flax tree of numpy
    arrays, every dict's keys sorted as ``jax.device_get`` leaves JAX's
    ``model.init`` output (so ``matched`` / ``missing`` come in JAX's
    order)."""
    from ..models.convert import _sorted, variables_to_numpy
    return _sorted(variables_to_numpy(model))


def load_into_model(model, ckpt_path: str, strict: bool = True):
    """Load a reference checkpoint into the sim ``model`` (ViT or Swin), in
    place.

    The template is the sim's own variables (:func:`template_of`); every
    leaf the checkpoint holds replaces the template's, the others keep the
    sim's values (its seeded init, where JAX's keeps ``model.init``'s).
    Returns ``(variables, report)``: the merged numpy tree, now also the
    sim's, and ``{"matched", "missing", "model_config"}``.  ``strict``
    raises, before anything is written, if a leaf is missing.
    """
    from ..models.convert import variables_to_torch

    state, model_config = load_torch_checkpoint(ckpt_path)
    params_in, qstats_in = convert_state_dict(state)

    template = template_of(model)
    params, m1, miss1 = _merge_into(template["params"], params_in)
    qstats, m2, miss2 = _merge_into(template["quant_stats"], qstats_in)
    report = {
        "matched": m1 + m2,
        "missing": miss1 + miss2,
        "model_config": model_config,
    }
    if strict and (miss1 or miss2):
        raise ValueError(f"checkpoint missing leaves: {miss1 + miss2}")
    variables = {"params": params, "quant_stats": qstats}
    variables_to_torch(model, variables)
    return variables, report


def model_from_config(model_config: dict, device=None, seed: int = 0):
    """Rebuild the sim from an embedded ``model_config`` (model name, the 8
    bitwidths and the 3 approximation type strings), on ``device``
    (``cuda`` unless ``"cpu"``), its parameters from ``seed``."""
    from ..models import BitWidths, str2model

    name = model_config.get("model", model_config.get("model_name"))
    bw = BitWidths(
        patch_embed=model_config.get("patch_embed_bitwidth", 8),
        pos_encoding=model_config.get("pos_encoding_bitwidth", 8),
        block_input=model_config.get("block_input_bitwidth", 8),
        attention_out=model_config.get("attention_out_bitwidth", 8),
        softmax=model_config.get("softmax_bitwidth", 8),
        mlp_out=model_config.get("mlp_out_bitwidth", 8),
        norm2_in=model_config.get("norm2_in_bitwidth", 8),
        att_block_out=model_config.get("att_block_out_bitwidth", 8),
    )
    return str2model(name)(
        bitwidths=bw,
        gelu_type=model_config.get("gelu_type", "ivit"),
        softmax_type=model_config.get("softmax_type", "ivit"),
        layernorm_type=model_config.get("layernorm_type", "ivit"),
        device=device, seed=seed,
    )
