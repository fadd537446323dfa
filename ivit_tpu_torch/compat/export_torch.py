"""Export a sim's variables to the reference's checkpoint schema
(counterpart of ``ivit_tpu/compat/export_torch.py``).

Inverse of ``torch_ckpt.convert_state_dict``: writes a ``.pth.tar`` whose
``model`` state_dict uses the reference names/layouts (``blocks.N.``,
``[O, I]`` linear weights, OIHW convs, QuantAct buffers) **plus every
registered buffer the reference model persists**, so the file satisfies the
reference trainer's strict ``model.load_state_dict`` and feeds its TVM
converter directly:

* per-linear/conv: ``weight_integer`` / ``bias_integer`` /
  ``fc_scaling_factor`` (``conv_scaling_factor``), with ``bias_integer =
  round(bias / (w_scale * s_in))`` using the *input activation scale chain*
  (the same chain ``engine/freeze.py`` walks),
* per-QuantAct: ``x_min`` / ``x_max`` / ``act_scaling_factor`` (synthesized
  from the ranges with the reference's symmetric-scale formula),
* ``matmul_1`` / ``matmul_2`` ``act_scaling_factor`` (the product of the two
  input scales),
* family buffers: ivit LN ``norm_scaling_factor``/``bias_integer``, ivit
  GELU/Softmax output ``act_scaling_factor``, ibert LN ``shift``, ibert GELU
  ``input_scaling_factor``.

Every precision is JAX's: the symmetric scales in f32, ``bias_integer``
from an f64 product rounded to f32, the ivit LN buffers in f64, the matmul
scale records in f32, numpy's half-to-even ``np.round`` throughout.
Derived buffers are emitted for the ViT/DeiT family with the ivit, ibert
and float nonlinearity types; Swin and ppoly variables export names,
weights and ranges only (as JAX's exporter does).  One deliberate
difference: a Swin tree's 16-bit QuantActs (the stage input ``qact1`` and
each block's ``qact2``, ``qact4``, ``attn.qact4`` and the ibert softmax's
``attn.int_softmax.act``) get their scales at
16 bits, as the sim computes them, where JAX's exporter writes the 8-bit
formula; so a Swin sim's checkpoint reloads leaf for leaf.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)


def _sym_scale(bits, lo, hi):
    n = 2 ** (bits - 1) - 1
    return np.maximum(
        np.maximum(-np.asarray(lo, np.float32), np.asarray(hi, np.float32))
        / np.float32(n), F32_EPS).astype(np.float32)


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _flatten(tree, prefix=""):
    """Flat dotted names, every level's keys sorted (``jax.device_get``'s
    order, so the state_dict's keys come in JAX's order)."""
    out = {}
    for k, v in sorted(tree.items()):
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = _numpy(v)
    return out


def ref_name(name: str) -> str:
    """A flat flax variable name -> the reference state_dict name."""
    parts = name.split(".")
    if parts[0].startswith("blocks_"):
        parts = ["blocks", parts[0].split("_", 1)[1]] + parts[1:]
    if parts[0].startswith("layers_"):   # swin: layers_i_blocks_d etc.
        bits = parts[0].split("_")
        parts = ["layers", bits[1]] + bits[2:] + parts[1:]
    return ".".join(parts)


_SWIN_16 = ("qact2", "qact4", "attn.qact4", "attn.int_softmax.act")


def _qact_bits(bw: dict, swin: bool = False):
    """Map reference qact base name -> activation bitwidth.

    Mirrors the QuantAct constructions of the sims (``models/vit.py``,
    ``models/swin.py``): everything is 8-bit except the sites the
    8-position bitwidth vector overrides, the ibert softmax's internal
    16-bit exp QuantAct, and (``swin``) Swin's 16-bit stage input and block
    residual QuantActs.
    """
    def bits(base: str) -> int:
        if swin:
            m = re.match(r"layers\.\d+\.blocks\.\d+\.(.+)$", base)
            if base == "qact1" or (m and m.group(1) in _SWIN_16):
                return 16
        if base == "qact_input" or base == "qact2":
            return 8
        if base == "patch_embed.qact":
            return bw.get("patch_embed", 8)
        if base == "qact_pos":
            return bw.get("pos_encoding", 8)
        if base == "qact1":
            return bw.get("block_input", 8)
        m = re.match(r"blocks\.\d+\.(.+)$", base)
        if not m:
            return 8
        inner = m.group(1)
        return {
            "qact2": bw.get("norm2_in", 8),
            "qact4": bw.get("att_block_out", 8),
            "attn.qact3": bw.get("attention_out", 8),
            "attn.int_softmax.act": 16,
            "mlp.qact2": bw.get("mlp_out", 8),
        }.get(inner, 8)
    return bits


def _linear_sites(out: Dict[str, np.ndarray]):
    """(linear base, input-qact base, is_conv) triples present in ``out``:
    the input side of each GEMM in the reference graph."""
    sites = []
    if "patch_embed.proj.weight" in out:
        sites.append(("patch_embed.proj", "qact_input", True))
    if "head.weight" in out:
        sites.append(("head", "qact2", False))
    for key in out:
        m = re.match(r"(blocks\.(\d+))\.attn\.qkv\.weight$", key)
        if m:
            b = m.group(1)
            sites += [(f"{b}.attn.qkv", f"{b}.qact1", False),
                      (f"{b}.attn.proj", f"{b}.attn.qact2", False),
                      (f"{b}.mlp.fc1", f"{b}.qact3", False),
                      (f"{b}.mlp.fc2", f"{b}.mlp.qact1", False)]
    return sites


def to_reference_state_dict(variables: dict,
                            model_config: Optional[dict] = None
                            ) -> Dict[str, np.ndarray]:
    """A flax ``{params, quant_stats}`` tree (numpy arrays or tensors, as
    ``models.convert.variables_to_numpy`` gives it) -> the reference-style
    flat state_dict of numpy arrays.

    ``model_config`` (the keys the training CLI persists) selects the
    nonlinearity families and bitwidths used to derive the reference's
    registered buffers; defaults to the all-'ivit', all-8-bit config.
    """
    cfg = dict(model_config or {})
    gelu_t = str(cfg.get("gelu_type", "ivit")).split("_")[0]
    sm_t = str(cfg.get("softmax_type", "ivit")).split("_")[0]
    ln_t = str(cfg.get("layernorm_type", "ivit")).split("_")[0]
    sm_bit = int(cfg.get("softmax_bitwidth", cfg.get("softmax", 8)))
    params = _flatten(variables["params"])
    bits_of = _qact_bits({k.replace("_bitwidth", ""): v
                          for k, v in cfg.items() if isinstance(v, int)},
                         swin=any(k.startswith("layers_") for k in params))
    qstats = _flatten(variables.get("quant_stats", {}))
    out: Dict[str, np.ndarray] = {}

    for name, value in params.items():
        rname = ref_name(name)
        if rname.endswith(".kernel"):
            base = rname[: -len(".kernel")]
            if value.ndim == 4:          # HWIO -> OIHW
                out[base + ".weight"] = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:        # [I,O] -> [O,I]
                out[base + ".weight"] = value.T
            else:
                out[base + ".weight"] = value
        else:
            out[rname] = value

    for name, value in qstats.items():
        out[ref_name(name)] = value

    # --- synthesized QuantAct scales (the reference's symmetric scale) ------
    qact_bases = [k[: -len(".x_min")] for k in out if k.endswith(".x_min")]
    for base in qact_bases:
        out[base + ".act_scaling_factor"] = _sym_scale(
            bits_of(base), out[base + ".x_min"], out[base + ".x_max"])

    def scale_of(base):
        return np.float64(out[base + ".act_scaling_factor"].reshape(-1)[0])

    # --- derived linear/conv integer buffers --------------------------------
    for base, qact, is_conv in _linear_sites(out):
        if qact + ".act_scaling_factor" not in out:
            continue                     # chain unavailable (e.g. swin tree)
        w = out[base + ".weight"]
        flat = w.reshape(w.shape[0], -1)
        w_scale = _sym_scale(8, flat.min(axis=1), flat.max(axis=1))
        w_int = np.clip(np.round(flat / w_scale[:, None]), -128,
                        127).reshape(w.shape)
        out[base + (".conv_scaling_factor" if is_conv else
                    ".fc_scaling_factor")] = w_scale
        out[base + ".weight_integer"] = w_int.astype(np.float32)
        if base + ".bias" in out:
            bias_scale = (w_scale.astype(np.float64) * scale_of(qact)
                          ).astype(np.float32)
            n31 = 2.0**31
            out[base + ".bias_integer"] = np.clip(
                np.round(out[base + ".bias"] / bias_scale), -n31,
                n31 - 1).astype(np.float32)

    # --- attention matmul scale records -------------------------------------
    s_sm = np.float32(2.0 ** (1 - sm_bit))   # softmax out scale, all families
    for key in list(out):
        m = re.match(r"(blocks\.\d+)\.attn\.qact1\.act_scaling_factor$", key)
        if not m:
            continue
        b = m.group(1)
        s_q = out[key].reshape(1).astype(np.float32)
        out[f"{b}.attn.matmul_1.act_scaling_factor"] = s_q * s_q
        out[f"{b}.attn.matmul_2.act_scaling_factor"] = s_sm * s_q

    # --- nonlinearity-family buffers ----------------------------------------
    ln_bases = [k[: -len(".weight")] for k in out
                if k.endswith(".weight") and out[k].ndim == 1
                and re.search(r"(^|\.)norm\d?$", k[: -len(".weight")])]
    if ln_t == "ivit":
        for base in ln_bases:
            gamma = out[base + ".weight"].astype(np.float64)
            beta = out[base + ".bias"].astype(np.float64)
            dim_base = np.sqrt(np.float64(gamma.shape[0])) / 2.0**30
            out[base + ".bias_integer"] = np.floor(
                (beta / gamma) / dim_base).astype(np.float32)
            out[base + ".norm_scaling_factor"] = (
                dim_base * gamma).astype(np.float32)

    for key in list(out):
        m = re.match(r"(blocks\.\d+)\.mlp\.qact_gelu\.act_scaling_factor$",
                     key)
        if not m:
            continue
        b = m.group(1)
        s_g = out[key].reshape(1).astype(np.float32)
        if gelu_t == "ivit":             # ShiftGELU out scale: s_in / 2**7
            out[f"{b}.mlp.act.act_scaling_factor"] = s_g / np.float32(2.0**7)
        elif gelu_t == "ibert":
            out[f"{b}.mlp.act.input_scaling_factor"] = s_g
        if sm_t == "ivit":               # Shiftmax out scale: 1 / 2**(bit-1)
            out[f"{b}.attn.int_softmax.act_scaling_factor"] = np.full(
                (1,), 2.0 ** (1 - sm_bit), np.float32)

    return out


def save_reference_checkpoint(variables: dict, model_config: dict,
                              path: str, **extra):
    """Write a reference-compatible ``.pth.tar``: ``{"model": state_dict of
    f32 tensors, "model_config": model_config, **extra}``."""
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
             for k, v in to_reference_state_dict(variables,
                                                 model_config).items()}
    torch.save({"model": state, "model_config": model_config, **extra}, path)
