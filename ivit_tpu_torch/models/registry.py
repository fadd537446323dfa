"""Parameterized nonlinearity names (counterpart of
``ivit_tpu/models/registry.py::parse_layer_name``; the layer registries
come with the QAT model)."""

from __future__ import annotations


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
