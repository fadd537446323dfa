"""The port's checkpoint interop (``ivit_tpu_torch/compat``, ``ops/dyadic.py``)
against the JAX package's, bitwise.

At ``tests/test_engine.py``'s 64 px ViT geometry (depth 2, embed 64, 2
heads) and the 56 px Swin of ``test_torch_port_swin_freeze.py``, the port's
own sims, calibrated on two seeded batches, give the variable trees
(``variables_to_numpy``; the JAX package's initialisation is not needed):

* ``to_reference_state_dict`` key for key, dtype, shape and value equal to
  JAX's for the ivit, ibert and float families, an INT16 ``model_config``
  and a Swin tree -- but for the Swin's 16-bit QuantAct scales, which the
  port writes at 16 bits, as the sim holds them (JAX's exporter writes the
  8-bit formula there: the one deliberate difference, ROADMAP Queue 3);
  ``convert_state_dict`` of JAX's state dicts equal to JAX's conversion;
* a ``.pth.tar`` written by JAX's ``save_reference_checkpoint`` loads into
  the port's sim, and one written by the port's into JAX's loader, both to
  the variables written; the ``matched`` / ``missing`` lists equal JAX's
  (a timm-style float file: every quantization leaf missing), the matched
  leaves bitwise JAX's.  JAX's ``load_into_model`` is its
  ``load_torch_checkpoint``, ``convert_state_dict`` and ``_merge_into``
  over ``model.init``'s tree: the tests run those JAX functions over the
  port sim's tree (:func:`_jax_load`), which has JAX's structure
  (``variables_to_torch`` holds it to that) and JAX's sorted key order
  (checked against ``jax.device_get``), since a JAX ``model.init`` costs
  10-25 s here;
* ``model_from_config``; ``convert_npz``, ``load_npz_into_model`` and
  ``resize_pos_embed`` against JAX's: bitwise for an equal grid, and for a
  resized one within the bound :func:`_resize_bound` states;
* ``load_pretrained(local_path=...)`` for a torch and an npz file, and
  ``fetch_pretrained``'s refusal to download;
* ``ops/dyadic.py`` against JAX's module on ``tests/test_dyadic.py``'s
  cases.
"""

import decimal
import os
import re
import sys
from decimal import Decimal

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_flax_npz import make_npz  # noqa: E402

from ivit_tpu.compat import export_torch as jexp  # noqa: E402
from ivit_tpu.compat import flax_npz as jnpz  # noqa: E402
from ivit_tpu.compat import torch_ckpt as jckpt  # noqa: E402
from ivit_tpu.models import BitWidths as JaxBitWidths  # noqa: E402
from ivit_tpu.ops import dyadic as jdy  # noqa: E402
from ivit_tpu_torch.compat import export_torch as texp  # noqa: E402
from ivit_tpu_torch.compat import flax_npz as tnpz  # noqa: E402
from ivit_tpu_torch.compat import pretrained as tpre  # noqa: E402
from ivit_tpu_torch.compat import torch_ckpt as tckpt  # noqa: E402
from ivit_tpu_torch.models import SwinTransformer, VisionTransformer  # noqa: E402
from ivit_tpu_torch.models.convert import (differing_leaves,  # noqa: E402
                                           variables_to_numpy)
from ivit_tpu_torch.models.vit_float import (FloatVisionTransformer,  # noqa: E402
                                             timm_state_dict)
from ivit_tpu_torch.ops import dyadic as tdy  # noqa: E402

VIT = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
           num_classes=10)
SWIN = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
            num_heads=(2, 4), window_size=7, num_classes=10, drop_path_rate=0.0)
INT16 = "8,8,8,8,16,8,16,8"
# name -> (gelu, softmax, ln, bitwidths)
VIT_CONFIGS = {"ivit": ("ivit", "ivit", "ivit", "8"),
               "ibert": ("ibert", "ibert", "ibert", "8"),
               "float": ("float", "float", "float", "8"),
               "int16": ("ivit", "ivit", "ivit", INT16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU forwards: Tier-1 runs
    six workers at once (the bits do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_config(gelu, softmax, ln, bits, model="deit_tiny_patch16_224"):
    bw = JaxBitWidths.from_spec(bits)
    return {"model": model, "gelu_type": gelu, "softmax_type": softmax,
            "layernorm_type": ln, "patch_embed_bitwidth": bw.patch_embed,
            "pos_encoding_bitwidth": bw.pos_encoding,
            "block_input_bitwidth": bw.block_input,
            "attention_out_bitwidth": bw.attention_out,
            "softmax_bitwidth": bw.softmax, "mlp_out_bitwidth": bw.mlp_out,
            "norm2_in_bitwidth": bw.norm2_in,
            "att_block_out_bitwidth": bw.att_block_out}


def _port_vit(name, seed=0, calibrate=True):
    gelu, softmax, ln, bits = VIT_CONFIGS[name]
    model = VisionTransformer(bitwidths=bits, gelu_type=gelu, softmax_type=softmax,
                              layernorm_type=ln, device="cpu", seed=seed, **VIT)
    if calibrate:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for _ in range(2):
                model(torch.from_numpy(rng.normal(size=(2, 64, 64, 3))
                                       .astype(np.float32)), running_stat=True)
    return model


def _jax_load(path, template):
    """JAX's ``load_into_model`` (``strict=False``) over ``template`` for
    ``model.init``'s tree: ``(variables, {"matched", "missing"})``."""
    state, _ = jckpt.load_torch_checkpoint(path)
    params_in, qstats_in = jckpt.convert_state_dict(state)
    params, m1, x1 = jckpt._merge_into(template["params"], params_in)
    qstats, m2, x2 = jckpt._merge_into(template["quant_stats"], qstats_in)
    return ({"params": params, "quant_stats": qstats},
            {"matched": m1 + m2, "missing": x1 + x2})


def _template(model):
    """The port's merge template, in the key order ``jax.device_get`` gives
    JAX's ``model.init`` tree."""
    tpl = tckpt.template_of(model)
    assert _keys(tpl) == _keys(jax.device_get(tpl))
    return tpl


def _keys(tree, path=()):
    return [p for k, v in tree.items()
            for p in (_keys(v, path + (k,)) if isinstance(v, dict) else [path + (k,)])]


def _port_swin(seed=0, calibrate=True):
    model = SwinTransformer(gelu_type="ivit", softmax_type="ivit",
                            layernorm_type="ivit", device="cpu", seed=seed, **SWIN)
    if calibrate:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for _ in range(2):
                model(torch.from_numpy(rng.normal(size=(2, 56, 56, 3))
                                       .astype(np.float32)), running_stat=True)
    return model


@pytest.fixture(scope="module")
def trees():
    """name -> (port sim, its variables, model_config): the four ViT
    configurations and the Swin."""
    out = {}
    for name, (gelu, softmax, ln, bits) in VIT_CONFIGS.items():
        model = _port_vit(name)
        out[name] = (model, variables_to_numpy(model),
                     _model_config(gelu, softmax, ln, bits))
    model = _port_swin()
    out["swin"] = (model, variables_to_numpy(model),
                   {"model": "swin_tiny_patch4_window7_224", "gelu_type": "ivit",
                    "softmax_type": "ivit", "layernorm_type": "ivit"})
    return out


def _eq_state(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


_SWIN_16 = re.compile(r"(qact1|layers\.\d+\.blocks\.\d+\.(qact2|qact4|attn\.qact4))"
                      r"\.act_scaling_factor$")


@pytest.mark.parametrize("name", list(VIT_CONFIGS) + ["swin"])
def test_to_reference_state_dict_matches_jax(trees, name):
    _, variables, cfg = trees[name]
    got = texp.to_reference_state_dict(variables, cfg)
    want = jexp.to_reference_state_dict(variables, cfg)
    if name == "swin":
        # the 16-bit scales: the sim's own records (which convert back to
        # them), where JAX's exporter writes the 8-bit formula
        wide = [k for k in want if _SWIN_16.match(k)]
        assert len(wide) == 13
        back = tckpt.convert_state_dict({k: got[k] for k in wide})[1]
        assert differing_leaves(back, _subtree(variables["quant_stats"], back)) == []
        assert all(not np.array_equal(got[k], want[k]) for k in wide)
        for k in wide:
            got.pop(k), want.pop(k)
    _eq_state(got, want)
    if name != "swin":
        assert "blocks.0.attn.qkv.bias_integer" in got        # derived buffers written


def _subtree(tree, like):
    """``tree`` cut to the keys of ``like``."""
    return {k: _subtree(tree[k], v) if isinstance(v, dict) else tree[k]
            for k, v in like.items()}


@pytest.mark.parametrize("name", ["ibert", "swin"])
def test_convert_state_dict_matches_jax(trees, name):
    _, variables, cfg = trees[name]
    state = jexp.to_reference_state_dict(variables, cfg)
    got, want = tckpt.convert_state_dict(state), jckpt.convert_state_dict(state)
    assert differing_leaves(list(got), list(want)) == []
    # the conversion returns the tree written, leaf for leaf
    assert differing_leaves(got[0], variables["params"]) == []


@pytest.mark.parametrize("name", ["ivit", "ibert", "swin"])
def test_checkpoints_cross_both_ways(trees, name, tmp_path):
    """JAX's file into the port's fresh sim, the port's into JAX's model:
    the variables written come back; the reports equal JAX's."""
    model, variables, cfg = trees[name]
    jax_file, port_file = str(tmp_path / "jax.pth.tar"), str(tmp_path / "port.pth.tar")
    jexp.save_reference_checkpoint(variables, cfg, jax_file)
    texp.save_reference_checkpoint(variables, cfg, port_file)

    fresh = _port_swin(seed=1, calibrate=False) if name == "swin" else \
        _port_vit(name, seed=1, calibrate=False)
    template = _template(fresh)
    got, report = tckpt.load_into_model(fresh, jax_file)
    # JAX's file: a Swin's 16-bit scale records hold JAX's 8-bit formula
    diff = [d for d in differing_leaves(got, variables)]
    assert len(diff) == (13 if name == "swin" else 0), diff
    assert all(d.endswith("/act_scaling_factor") for d in diff)
    assert differing_leaves(variables_to_numpy(fresh), got) == []
    assert report["model_config"] == cfg
    # the port's file reloads leaf for leaf
    assert differing_leaves(tckpt.load_into_model(fresh, port_file)[0], variables) == []

    want, jreport = _jax_load(port_file, template)
    assert differing_leaves(want, variables) == []
    assert report["matched"] == jreport["matched"]
    assert report["missing"] == jreport["missing"] == []


def _write_timm(tmp_path, seed=3):
    """A timm-style float DeiT ``.pth`` from the port's seeded float ViT."""
    fm = FloatVisionTransformer(img_size=64, patch_size=16, embed_dim=64, depth=2,
                                num_heads=2, num_classes=10, device="cpu", seed=seed)
    path = str(tmp_path / "deit_timm.pth")
    torch.save({"model": timm_state_dict(fm)}, path)
    return path


def _leaf(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return np.asarray(tree)


def test_float_file_loads_as_jax_loads_it(tmp_path):
    """A timm-style float file (no quantization leaf): not strict, the
    matched leaves bitwise JAX's, the same matched / missing lists; strict
    raises, with nothing written."""
    path = _write_timm(tmp_path)
    model = _port_vit("ivit", seed=1, calibrate=False)
    before = variables_to_numpy(model)
    template = _template(model)
    with pytest.raises(ValueError, match="missing leaves"):
        tckpt.load_into_model(model, path)
    assert differing_leaves(variables_to_numpy(model), before) == []
    got, report = tckpt.load_into_model(model, path, strict=False)
    want, jreport = _jax_load(path, template)
    assert report["matched"] == jreport["matched"]
    assert report["missing"] == jreport["missing"]
    # every parameter comes from the file, no quantization leaf does
    assert report["missing"] and all(_has(got["quant_stats"], m) for m in report["missing"])
    assert all(_has(got["params"], m) for m in report["matched"])
    for dotted in report["matched"]:
        g, w = _leaf(got["params"], dotted), _leaf(want["params"], dotted)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=dotted)
    # the leaves the file lacks keep the sim's values
    for dotted in report["missing"]:
        np.testing.assert_array_equal(_leaf(got["quant_stats"], dotted),
                                      _leaf(before["quant_stats"], dotted))


def _has(tree, dotted):
    for k in dotted.split("."):
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return True


@pytest.mark.parametrize("name", ["ivit", "int16"])
def test_model_from_config(trees, name):
    _, _, cfg = trees[name]
    got = tckpt.model_from_config(cfg, device="cpu")
    want = jckpt.model_from_config(cfg)
    assert (got.gelu_type, got.softmax_type, got.layernorm_type) == \
        (want.gelu_type, want.softmax_type, want.layernorm_type)
    assert list(got.bitwidths.to_list()) == list(want.bitwidths.to_list())
    assert (got.embed_dim, got.depth, got.num_heads) == (192, 12, 3)


def _resize_bound(pos, gs_new):
    """Elementwise bound on |port - JAX| for a resized grid: 2**-16 (256
    f32 ulps) of |W|^T |X| |W|, the sum of the magnitudes of the terms.
    Both compute the same two contractions (rows, then columns) with the
    same weights, but JAX's run inside one jitted XLA graph, which sums in
    its own order and fuses the Keys polynomial (its weights there move
    from the eager ones, which the port's equal bitwise, by a few ulps of
    the polynomial's terms); neither is the exact sum.  The bound is
    tight enough to tell the kernel: torch's bicubic (a = -0.75) differs
    by ~1e-2."""
    m = int(np.sqrt(pos.shape[1] - 1))
    w = np.abs(tnpz.resize_weights(m, gs_new)).astype(np.float64)
    grid = np.abs(pos[0, 1:].reshape(m, m, -1)).astype(np.float64)
    mag = np.einsum("hwc,ha,wb->abc", grid, w, w).reshape(1, gs_new * gs_new, -1)
    return 2.0**-16 * np.concatenate([np.zeros_like(pos[:, :1], np.float64), mag],
                                     axis=1)


@pytest.mark.parametrize("old,new", [(4, 4), (4, 2), (4, 7), (24, 14), (14, 24)])
def test_resize_pos_embed_matches_jax(old, new):
    rng = np.random.default_rng(old * 100 + new)
    pos = rng.normal(size=(1, old * old + 1, 64)).astype(np.float32)
    got = tnpz.resize_pos_embed(pos, new * new + 1)
    want = jnpz.resize_pos_embed(pos, new * new + 1)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, :1], want[:, :1])
    if old == new:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got.astype(np.float64) - want) <= _resize_bound(pos, new))
        # and the weights themselves are JAX's, bitwise
        from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat
        np.testing.assert_array_equal(
            tnpz.resize_weights(old, new),
            np.asarray(compute_weight_mat(old, new, new / old, 0.0,
                                          _fill_keys_cubic_kernel, True)))


@pytest.mark.parametrize("grid", [4, 2])
def test_convert_and_load_npz_match_jax(tmp_path, grid):
    """A 4x4-grid npz into the 64 px sim (equal grid, bitwise) and a 2x2 one
    (resized: the position embedding within :func:`_resize_bound`, every
    other leaf bitwise); the port's load reports JAX's lists, its leaves
    JAX's merge of them."""
    path = make_npz(tmp_path, grid=grid)
    got = tnpz.convert_npz(np.load(path), depth=2, num_patches=16)
    want = jnpz.convert_npz(np.load(path), depth=2, num_patches=16)
    pos_got, pos_want = got["pos_embed"], want["pos_embed"]
    assert differing_leaves({**got, "pos_embed": 0}, {**want, "pos_embed": 0}) == []
    if grid == 4:
        np.testing.assert_array_equal(pos_got, pos_want)
    else:
        pos = np.load(path)["Transformer/posembed_input/pos_embedding"]
        assert np.all(np.abs(pos_got.astype(np.float64) - pos_want)
                      <= _resize_bound(pos, 4))
    model = _port_vit("ivit", seed=1, calibrate=False)
    template = _template(model)
    variables, report = tnpz.load_npz_into_model(model, path)
    # JAX's load_npz_into_model over the same template
    jparams, matched, missing = jckpt._merge_into(template["params"], want)
    assert report == {"matched": matched, "missing": missing} and missing == []
    jparams["pos_embed"] = variables["params"]["pos_embed"]
    assert differing_leaves(variables["params"], jparams) == []
    assert differing_leaves(variables["quant_stats"], template["quant_stats"]) == []
    assert differing_leaves(variables_to_numpy(model), variables) == []


def test_load_pretrained_local_files(tmp_path, monkeypatch):
    """``local_path`` for a torch and an npz checkpoint; with no file the
    loader raises naming the URL and the place to drop the file, and opens
    no connection."""
    model = _port_vit("ivit", seed=1, calibrate=False)
    _, report = tpre.load_pretrained(model, "deit_tiny_patch16_224",
                                     local_path=_write_timm(tmp_path))
    assert "blocks_0.attn.qkv.kernel" in report["matched"]
    _, report = tpre.load_pretrained(model, "vit_base_patch16_224",
                                     local_path=make_npz(tmp_path))
    assert "blocks_1.mlp.fc2.kernel" in report["matched"]

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    url = tpre.PRETRAINED_URLS["deit_small_patch16_224"][0]
    with pytest.raises(FileNotFoundError) as err:
        tpre.load_pretrained(model, "deit_small_patch16_224")
    dest = str(tmp_path / "cache" / "ivit_tpu_torch" / "pretrained" / os.path.basename(url))
    assert url in str(err.value) and dest in str(err.value)
    os.makedirs(os.path.dirname(dest))
    torch.save({"model": timm_state_dict(FloatVisionTransformer(
        img_size=64, embed_dim=64, depth=2, num_heads=2, num_classes=10,
        device="cpu"))}, dest)
    assert tpre.fetch_pretrained("deit_small_patch16_224") == dest
    with pytest.raises(KeyError):
        tpre.fetch_pretrained("resnet50")


def test_port_compat_opens_no_connection():
    src = "".join(open(os.path.join(os.path.dirname(tpre.__file__), f)).read()
                  for f in ("pretrained.py", "torch_ckpt.py", "flax_npz.py",
                            "export_torch.py"))
    for word in ("urllib", "urlopen", "socket", "http.client", "requests"):
        assert word not in src, word


def _reference_batch_frexp(inputs, max_bit=31):
    """``tests/test_dyadic.py``'s verbatim reference formula."""
    m_f, e_f = np.frexp(np.asarray(inputs, dtype=np.float64))
    out_m = [int(Decimal(m * (2**max_bit)).quantize(
        Decimal("1"), rounding=decimal.ROUND_HALF_UP)) for m in m_f]
    return np.array(out_m, dtype=np.int64), (float(max_bit) - e_f).astype(np.int64)


def test_dyadic_matches_jax():
    rng = np.random.default_rng(0)
    scales = np.concatenate([
        10.0 ** rng.uniform(-12, 4, size=2000),
        np.array([1.0, 0.5, 2.0, 1 / 3, 2 / 3, 1e-9, 127.0, 1 / 127]),
    ])
    m, e = tdy.batch_frexp(scales)
    jm, je = jdy.batch_frexp(scales)
    for got, want in ((m, jm), (e, je)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    rm, re_ = _reference_batch_frexp(scales)
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(e, re_)
    np.testing.assert_array_equal(tdy.dyadic_to_multiplier(m, e),
                                  jdy.dyadic_to_multiplier(jm, je))
    d, jd = tdy.Dyadic.from_ratio(np.array([0.037])), jdy.Dyadic.from_ratio(np.array([0.037]))
    z = rng.integers(-(2**20), 2**20, size=10000)
    np.testing.assert_array_equal(d.apply_exact(z), jd.apply_exact(z))
    np.testing.assert_array_equal(d.multiplier, jd.multiplier)
