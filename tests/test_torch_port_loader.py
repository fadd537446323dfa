"""The port loads the JAX package's engine artifacts leaf for leaf."""

import dataclasses
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_engine import build_calibrated  # noqa: E402

from ivit_tpu.engine import freeze_model  # noqa: E402
from ivit_tpu.engine.export import load_engine as jax_load_engine  # noqa: E402
from ivit_tpu.engine.export import save_engine as jax_save_engine  # noqa: E402
from ivit_tpu_torch.engine import load_engine, save_engine  # noqa: E402
from ivit_tpu_torch.engine.convert import params_to_torch  # noqa: E402

_DT = {torch.int8: np.int8, torch.int32: np.int32, torch.float32: np.float32}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _assert_same_tree(torch_tree, np_tree):
    got = dict(_leaves(torch_tree))
    want = {k: np.asarray(v) for k, v in _leaves(np_tree)}
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", k
        assert np.dtype(_DT[t.dtype]) == want[k].dtype, k
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def _config_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["bitwidths"] = list(cfg.bitwidths.to_list())
    return d


def test_load_jax_artifact_leaf_for_leaf(rng, tmp_path):
    model, variables = build_calibrated(rng, gelu="ibert", softmax="ibert",
                                        ln="ibert", calib_batches=1)
    spec = freeze_model(model, variables)
    path = str(tmp_path / "engine")
    jax_save_engine(spec, path)
    loaded = load_engine(path, device="cpu")
    assert _config_dict(loaded.config) == _config_dict(spec.config)
    ref = jax.device_get(spec.params)
    _assert_same_tree(loaded.params, ref)
    # params_to_torch on the fetched tree gives the same tree
    _assert_same_tree(params_to_torch(ref, "cpu"), ref)

    # and back: the port's artifact loads in the JAX package unchanged
    path2 = str(tmp_path / "engine_port.npz")
    save_engine(loaded, path2)
    back = jax_load_engine(path2)
    assert back.config == spec.config
    _assert_same_tree(params_to_torch(jax.device_get(back.params), "cpu"), ref)
