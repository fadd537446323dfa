"""The port's ppoly family on Swin bit-exact against the JAX package
(tolerance 0), on a JAX freeze of the geometry of
``tests/test_swin_engine.py`` (56 px, embed 32, depths (2, 2), heads
(2, 4), window 7: a shifted stage-0 block, a merge, a stage 1 with res =
ws) with its ppoly families (``tests/test_swin_engine.py:88-96``: GELU and
softmax with the ibert backend, the ivit LN), calibrated on the batch of
its init and fitted by ``fit_ppoly_tables``.  The GELU sites skip the fit's boundary search
(``optim-bounds_false``): it is the fit's cost, seconds a site, and
``tests/test_torch_port_ppoly.py`` holds the port's search against JAX's.

* the shifted blocks' softmax: the polynomial, past the int8 offsets down
  to the shift mask, keeps every exp and row sum of 49 keys inside f32's
  exact integers (2**24), so a sum in any order is JAX's;
* the plain versions of the window-attention kernel (shifted, int16
  input; unshifted, int8 input) and of the Swin MLP kernel (int16 rows,
  fast-div on and off) against JAX ``swin_attn_block_p`` / ``mlp_block_p``
  in interpret mode;
* the engine: ``kernels=False`` against JAX ``pallas=False`` (the port
  with fast-div on and off), ``kernels=True`` against JAX ``pallas=True``
  in interpret mode, a per-stage mix against the unfused engine;
* the synthetic ppoly Swin spec has the freeze's tree and layout.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_engine import _images  # noqa: E402
from test_torch_port_swin import _eq, _stream, _to_port  # noqa: E402
from test_torch_port_swin_engine import _tree  # noqa: E402

import ivit_tpu.ops.pallas as ppkg  # noqa: E402
from ivit_tpu.engine import swin_int as jswin  # noqa: E402
from ivit_tpu.models.swin import SwinTransformer  # noqa: E402
from ivit_tpu.ops.pallas import block as jblk  # noqa: E402
from ivit_tpu.train.ppoly_fit import fit_ppoly_tables  # noqa: E402
from ivit_tpu_torch.engine import Engine, swin_engine_forward  # noqa: E402
from ivit_tpu_torch.engine.synthetic import synthetic_swin_spec  # noqa: E402
from ivit_tpu_torch.ops import ppoly as tpp  # noqa: E402
from ivit_tpu_torch.ops.kernels import block as kb  # noqa: E402

PPOLY = ("ppoly_backend_ibert_optim-bounds_false", "ppoly_backend_ibert", "ivit")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards: Tier-1 runs six
    workers at once, and a pool per worker as wide as the machine
    oversubscribes its cores (the integer paths' bits do not depend on the
    thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jspec():
    """``build_swin``'s model, calibrated on the batch of its init (jitted:
    an eager init of this Swin takes minutes on the CPU), fitted, frozen."""
    rng = np.random.default_rng(0)
    model = SwinTransformer(img_size=56, patch_size=4, embed_dim=32,
                            depths=(2, 2), num_heads=(2, 4), window_size=7,
                            num_classes=10, drop_path_rate=0.0,
                            gelu_type=PPOLY[0], softmax_type=PPOLY[1],
                            layernorm_type=PPOLY[2])
    x0 = jnp.asarray(rng.normal(size=(2, 56, 56, 3)).astype(np.float32))
    variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(0), a,
                                             running_stat=True))(x0)
    return jswin.freeze_swin_model(model, fit_ppoly_tables(model, variables))


def _blocks(jspec):
    """(shift, block leaves) of every attention block, in order."""
    params = jax.device_get(jspec.params)
    return [(shift, blk) for (kind, _, shift), blk
            in zip(jspec.config.layout, params["blocks"]) if kind == "block"]


def test_shifted_ppoly_row_sums_stay_exact(jspec):
    shifted = [blk for shift, blk in _blocks(jspec) if shift]
    assert shifted
    for blk in shifted:
        mask_min = float(blk["mask_int"].min())
        assert mask_min < -255                       # far below the int8 offsets
        x_off = torch.arange(mask_min - 255, 128, dtype=torch.float32)
        e = torch.floor(torch.clamp(tpp.eval_piecewise_poly(
            x_off, blk["sm_bounds"], blk["sm_coeffs"]), min=0) / 2**15)
        assert 49 * float(e.max()) < 2**24


def _attn_kw(blk, heads, nw, shift, as_t):
    keys = dict(ln_bias="ln1_bias_int", m_ln="m_ln1", ln_shift="ln1_shift",
                qkv_w="qkv_w", qkv_b="qkv_b", m_qkv="m_qkv", m_attn="m_attn",
                m_attn2="m_attn2", s_attn="s_attn", rel_addend="rel_bias_addend",
                m_av="m_av", proj_w="proj_w", proj_b="proj_b", m_proj="m_proj",
                m_res_x="m_res1_x", m_res_id="m_res1_id", sm_bounds="sm_bounds",
                sm_coeffs="sm_coeffs")
    kw = {k: as_t(blk[v]) for k, v in keys.items()}
    kw.update(mask_addend=as_t(blk["mask_int"]) if shift else None,
              num_heads=heads, n_windows=nw, ln_base="ivit", sm_base="ppoly",
              exp_bits=16)
    return kw


def test_swin_ppoly_attn_ref_matches_pallas(jspec):
    """Stage 0's shifted block on the int16 stream (4 windows an image),
    stage 1's first block on a merge's int8 output (1 window)."""
    blocks = _blocks(jspec)
    for (shift, blk), heads, nw, x in (
            (blocks[1], 2, 4, _stream((8, 49, 32), 16, seed=0)),
            (blocks[2], 4, 1, _stream((2, 49, 64), 8, seed=1))):
        want = jblk.swin_attn_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln1"]),
                                      interpret=True,
                                      **_attn_kw(blk, heads, nw, shift, jnp.asarray))
        got = kb.swin_attn_block(torch.from_numpy(x),
                                 **_attn_kw(blk, heads, nw, shift, torch.as_tensor))
        assert got.dtype == torch.int16
        _eq(got.numpy(), want)


MLP_KEYS = dict(ln_bias="ln2_bias_int", m_ln="m_ln2", ln_shift="ln2_shift",
                fc1_w="fc1_w", fc1_b="fc1_b", m_fc1="m_fc1", s_gelu="s_gelu",
                m_gelu="m_gelu", fc2_w="fc2_w", fc2_b="fc2_b", m_fc2="m_fc2",
                m_res_x="m_res2_x", m_res_id="m_res2_id",
                gelu_bounds="gelu_bounds", gelu_coeffs="gelu_coeffs",
                gelu_s_out="gelu_s_out", gelu_s_out_c="gelu_s_out_c",
                gelu_patch_h="gelu_patch_h", gelu_patch_d="gelu_patch_d")


@pytest.mark.parametrize("fastdiv", [True, False])
def test_swin_ppoly_mlp_ref_matches_pallas(jspec, fastdiv):
    blk = _blocks(jspec)[1][1]
    x = _stream((98, 32), 16, seed=4)
    flags = dict(ln_base="ivit", gelu_base="ppoly", mlp_bits=8, out_bits=16,
                 gelu_fastdiv=fastdiv)
    want = jblk.mlp_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln2"]),
                            out_dtype=jnp.int16, interpret=True, **flags,
                            **{k: jnp.asarray(blk[v]) for k, v in MLP_KEYS.items()})
    got = kb.mlp_block(torch.from_numpy(x), **flags,
                       **{k: torch.as_tensor(blk[v]) for k, v in MLP_KEYS.items()})
    assert got.dtype == torch.int16
    _eq(got.numpy(), want)


def test_swin_ppoly_engine_paths_match_jax(jspec):
    spec = _to_port(jspec)
    x = _images(2, 56, seed=6)
    want = np.asarray(jax.jit(lambda p, a: jswin.swin_engine_forward(
        type(jspec)(jspec.config, p), a, pallas=False))(jspec.params, jnp.asarray(x)))
    _eq(swin_engine_forward(spec, x, kernels=False, device="cpu").numpy(), want)
    ppkg.FORCE_INTERPRET = True
    try:
        want_p = np.asarray(jswin.swin_engine_forward(jspec, jnp.asarray(x),
                                                      pallas=True))
    finally:
        ppkg.FORCE_INTERPRET = False
    _eq(swin_engine_forward(spec, x, kernels=True, device="cpu").numpy(), want_p)
    _eq(want_p, want)               # JAX's two paths agree on the shifted sums
    _eq(Engine(spec, device="cpu", stage_paths=(True, False))(x).numpy(), want)
    # the rdiv form, which the gate proved equal to the fast-div one
    slow = type(spec)(dataclasses.replace(spec.config, ppoly_fastdiv=False),
                      spec.params)
    _eq(swin_engine_forward(slow, x, kernels=False, device="cpu").numpy(), want)
    assert jspec.config.ppoly_fastdiv
    assert np.isfinite(want).all() and want.std(axis=0).max() > 0


def test_swin_ppoly_synthetic_spec_has_the_freeze_tree(jspec):
    small = synthetic_swin_spec(_to_port(jspec).config, seed=0)
    assert _tree(small.params) == _tree(jax.device_get(jspec.params))
    assert small.config.layout == jspec.config.layout
    jc, sc = dataclasses.asdict(jspec.config), dataclasses.asdict(small.config)
    for k in ("bitwidths", "use_lut", "sm_sum_i32"):
        jc.pop(k), sc.pop(k)        # BitWidths types; no LUTs; scale-gated
    assert sc == jc
