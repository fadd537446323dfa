"""Nonlinearity registry and the parameterized-name DSL (counterpart of
``ivit_tpu/models/registry.py``): ``"ivit"``, ``"ibert_use-int-sqrt_true"``
or ``"ppoly_deg_2_seg_16_scale-bits_24_backend_ibert"`` resolve to layer
factories with the parsed keyword arguments baked in."""

from __future__ import annotations

import functools
import inspect

from . import layers as L

GELU_REGISTRY = {
    "float": L.FloatGELU,
    "ivit": L.IVITGELU,
    "ibert": L.IBERTGELU,
    "ppoly": L.PPolyGELU,
}

SOFTMAX_REGISTRY = {
    "float": L.FloatSoftmax,
    "ivit": L.IVITSoftmax,
    "ibert": L.IBERTSoftmax,
    "ppoly": L.PPolySoftmax,
}

LN_REGISTRY = {
    "float": L.FloatLayerNorm,
    "ivit": L.IVITLayerNorm,
    "ibert": L.IBERTLayerNorm,
}


def parse_layer_name(name: str):
    """``base_arg1_value1_arg2_value2`` -> (base, kwargs).

    Mirrors layer_selection.py:138-179 (hyphens -> underscores, bool/int/float
    coercion).
    """
    parts = name.lower().split("_")
    if len(parts) < 3:
        return name.lower(), {}
    base_name = parts[0]
    params = {}
    i = 1
    while i < len(parts) - 1:
        arg = parts[i].replace("-", "_")
        value_str = parts[i + 1]
        if value_str.lower() in ("true", "false"):
            value = value_str.lower() == "true"
        elif value_str.isdigit():
            value = int(value_str)
        else:
            try:
                value = float(value_str)
            except ValueError:
                value = value_str
        params[arg] = value
        i += 2
    return base_name, params


def _fields(cls):
    return set(inspect.signature(cls.__init__).parameters) - {"self"}


def _filter_kwargs(cls, kwargs):
    """The parsed keys ``cls`` takes; the rest are dropped, as the
    reference's setdefault ignores them (``registry.py:81``)."""
    fields = _fields(cls)
    return {k: v for k, v in kwargs.items() if k in fields}


def _lookup(registry, name):
    base, params = parse_layer_name(name)
    cls = registry[base if base in registry else name.lower()]
    return cls, _filter_kwargs(cls, params)


def get_gelu(name: str):
    """A no-argument factory for the GELU module named by ``name``."""
    cls, kwargs = _lookup(GELU_REGISTRY, name)
    return functools.partial(cls, **kwargs)


def get_softmax(name: str, output_bit: int = 8):
    """A no-argument factory for the softmax, its output bits baked in."""
    cls, kwargs = _lookup(SOFTMAX_REGISTRY, name)
    for key in ("output_bit", "bitwidth"):
        if key in _fields(cls):
            kwargs.setdefault(key, output_bit)
    return functools.partial(cls, **kwargs)


def get_layernorm(name: str):
    """A factory ``f(features)`` for the LayerNorm family."""
    cls, kwargs = _lookup(LN_REGISTRY, name)
    return functools.partial(cls, **kwargs)
