"""The frozen spec maker gives, leaf for leaf, the tree of the port's own
seeded fixture (``synthetic_spec`` / ``synthetic_swin_spec`` with
``with_tables``), so the yardstick's specs are the ones the port was
brought up on; a later change to that fixture cannot move them."""

import json
import os

import numpy as np
import pytest

from gpubench import cells, specmaker

SEEDS = (0, 2**31 + 12345)


def _leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _leaves_equal(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), path
        assert np.array_equal(x, y), path


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["deit_s_ibert", "swin_t_ivit"])
def test_spec_maker_is_the_ports_fixture_leaf_for_leaf(name, seed):
    from ivit_tpu_torch.engine import synthetic as syn

    cfg = json.load(open(os.path.join(cells.ROOT, f"gpubench/configs/{name}.json")))
    made_cfg, tree = specmaker.make(cfg, seed)
    if cfg["arch"] == "vit":
        port = syn.with_tables(syn.synthetic_spec(syn.deit_small_config(), seed))
    else:
        port = syn.with_tables(syn.synthetic_swin_spec(syn.swin_tiny_config(), seed))
        assert tuple(made_cfg["layout"]) == port.config.layout
    _leaves_equal(tree, port.params)
    for k in ("fast_exp", "fast_poly", "use_lut", "sm_sum_i32"):
        assert made_cfg[k] == getattr(port.config, k), k
    assert made_cfg["use_lut"]


def test_a_seed_gives_one_spec_and_another_seed_another():
    cfg = json.load(open(os.path.join(cells.ROOT, "gpubench/configs/deit_s_ibert.json")))
    cfg = {**cfg, "depth": 1}
    a, b, c = (specmaker.make(cfg, s)[1] for s in (5, 5, 6))
    _leaves_equal(a, b)
    assert not np.array_equal(a["blocks"][0]["qkv_w"], c["blocks"][0]["qkv_w"])
