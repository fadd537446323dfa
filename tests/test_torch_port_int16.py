"""The reference's INT16 configuration in the port, bit-exact against the
JAX package (tolerance 0).

The configuration is ``tests/test_engine.py``'s INT16 run: bitwidths
``8,8,8,8,16,8,16,8`` (16-bit softmax probabilities, a 16-bit ``norm2_in``
stream), the 64 px ViT of depth 2, here frozen by JAX for the ivit and the
ibert family.

* the port's unfused, fused (the kernels' plain versions) and ``"ops"``
  engines against JAX ``engine_forward`` with ``pallas=False`` / ``True`` /
  ``"ops"`` (Pallas in interpret mode, where JAX runs the 16-bit softmax
  through its split context dot, ``_ctx_dot``);
* ``attn_block_ref`` at ``sm_bit`` 16 with an int16 output against
  ``attn_block_p``, and ``mlp_block_ref`` from int16 rows to int8 against
  ``mlp_block_p``, both in interpret mode (the ppoly softmax's case, on the
  fitted tables of its own freeze, is in ``test_torch_port_ppoly.py``);
* the synthetic INT16 spec has the JAX freeze's tree and config, and at
  DeiT-S width it runs through JAX's unfused engine and the port's paths
  to the same logits;
* a one-hot ibert row (``chip_smoke.int16_edge_inputs``, the card's edge
  phase) rounds its probability to 2**(bits - 1); the port saturates it at
  the container's top as JAX's unfused engine does (XLA's f32 -> int
  conversion), at 8 and 16 bits; JAX's 16-bit Pallas context dot wraps it
  instead (a reference fault, ROADMAP Queue 3);
* the split of a 16-bit probability that the attention kernels' P v takes,
  ``p = 256 hi + lo``, is exact for every p in [0, 2**15 - 1] against every
  v in [-128, 127].
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
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import int16_edge_inputs  # noqa: E402
from test_torch_port_engine import _images, _to_jax, _to_port, _tree  # noqa: E402

import ivit_tpu.ops.pallas as ppkg  # noqa: E402
from ivit_tpu.engine import freeze_model  # noqa: E402
from ivit_tpu.engine.freeze import EngineSpec as JaxSpec  # noqa: E402
from ivit_tpu.engine import vit_int as jvit  # noqa: E402
from ivit_tpu.models import BitWidths as JaxBitWidths  # noqa: E402
from ivit_tpu.models import VisionTransformer  # noqa: E402
from ivit_tpu.ops.pallas import block as jblk  # noqa: E402
from ivit_tpu_torch.engine import Engine, engine_forward  # noqa: E402
from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec  # noqa: E402
from ivit_tpu_torch.models import BitWidths  # noqa: E402
from ivit_tpu_torch.engine import vit_int as tvit  # noqa: E402
from ivit_tpu_torch.ops.kernels import block as kb  # noqa: E402

INT16 = "8,8,8,8,16,8,16,8"
FAMILIES = ["ivit", "ibert"]
B, NP, NV = 2, 24, 17               # padded tokens, test_torch_port_ivit.py's


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


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
def freezes():
    """JAX freezes of ``test_engine.py``'s INT16 model (64 px, embed 64,
    depth 2, 2 heads), one family everywhere, calibrated on the batch of
    its (jitted) init."""
    out = {}
    for fam in FAMILIES:
        model = VisionTransformer(
            img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
            num_classes=10, gelu_type=fam, softmax_type=fam, layernorm_type=fam,
            bitwidths=JaxBitWidths.from_spec(INT16))
        x0 = jnp.asarray(_images(4, 64, seed=0))
        variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(0), a,
                                                 running_stat=True))(x0)
        out[fam] = freeze_model(model, variables)
    return out


def _jax_forward(jspec, x, pallas):
    """JAX ``engine_forward`` jitted (eagerly its ops take seconds each to
    compile), Pallas in interpret mode."""
    fwd = jax.jit(lambda params, a: jvit.engine_forward(
        JaxSpec(jspec.config, params), a, pallas=pallas))
    ppkg.FORCE_INTERPRET = True
    try:
        return np.asarray(fwd(jspec.params, jnp.asarray(x)))
    finally:
        ppkg.FORCE_INTERPRET = False


# --- (a) the three engine paths ------------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_int16_engine_paths_match_jax(freezes, fam):
    """Port ``kernels=False`` / ``True`` / ``"ops"`` against JAX
    ``pallas=False`` / ``True`` / ``"ops"`` (interpret mode); JAX runs the
    INT16 config on its fused kernels by default (``_int16_kernels_on``)."""
    jspec = freezes[fam]
    assert jspec.config.bitwidths.softmax == 16 and jvit._int16_kernels_on()
    spec = _to_port(jspec)
    assert spec.config.bitwidths == BitWidths.from_spec(INT16)
    x = _images(3, 64, seed=4)
    want = _jax_forward(jspec, x, False)
    _eq(engine_forward(spec, x, kernels=False, device="cpu").numpy(), want)
    for path in (True, "ops"):
        got = Engine(spec, device="cpu", kernels=path)(x)
        _eq(got.numpy(), _jax_forward(jspec, x, path))
    assert np.isfinite(want).all()


# --- (b) the kernels' plain versions ------------------------------------------

def _x8(seed, c):
    x = np.clip(np.round(np.random.default_rng(seed).normal(0, 32, (B, NP, c))),
                -128, 127).astype(np.int8)
    x[:, NV:] = 0
    return x


ATTN_KEYS = dict(ln_bias="ln1_bias_int", m_ln="m_ln1", ln_shift="ln1_shift",
                 qkv_w="qkv_w", qkv_b="qkv_b", m_qkv="m_qkv", m_attn="m_attn",
                 s_attn="s_attn", s_exp_act="s_exp_act", m_av="m_av",
                 proj_w="proj_w", proj_b="proj_b", m_proj="m_proj",
                 m_res_x="m_res1_x", m_res_id="m_res1_id")
MLP_KEYS = dict(ln_bias="ln2_bias_int", m_ln="m_ln2", ln_shift="ln2_shift",
                fc1_w="fc1_w", fc1_b="fc1_b", m_fc1="m_fc1", s_gelu="s_gelu",
                m_gelu="m_gelu", fc2_w="fc2_w", fc2_b="fc2_b", m_fc2="m_fc2",
                m_res_x="m_res2_x", m_res_id="m_res2_id")


def _kw(blk, keys, as_t):
    return {k: as_t(blk[v]) for k, v in keys.items() if v in blk}


@pytest.mark.parametrize("fam", FAMILIES)
def test_attn_block_ref_16bit_matches_pallas(freezes, fam):
    """``attn_block_ref`` at ``sm_bit`` 16, int8 in and int16 out (the
    INT16 config's attention half), padding tokens past ``n_valid``, fast
    flags both ways, against ``attn_block_p`` in interpret mode."""
    jspec = freezes[fam]
    blk = jax.device_get(jspec.params)["blocks"][0]
    x = _x8(1, jspec.config.embed_dim)
    for fast in (False, True):
        flags = dict(ln_base=fam, sm_base=fam, fast_exp=fast, fast_poly=fast,
                     num_heads=jspec.config.num_heads, n_valid=NV, sm_bit=16,
                     proj_bits=8, out_bits=16)
        want = jblk.attn_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln1"]),
                                 out_dtype=jnp.int16, interpret=True, **flags,
                                 **_kw(blk, ATTN_KEYS, jnp.asarray))
        before = kb.attn_block.launches
        got = kb.attn_block(torch.from_numpy(x), **flags,
                            **_kw(blk, ATTN_KEYS, torch.as_tensor))
        assert kb.attn_block.launches == before      # the CPU runs no kernel
        assert got.dtype == torch.int16
        _eq(got.numpy()[:, :NV], np.asarray(want)[:, :NV])
    assert np.abs(got.numpy()[:, :NV]).max() > 127   # the 16-bit range is used


@pytest.mark.parametrize("fam", FAMILIES)
def test_mlp_block_ref_int16_to_int8_matches_pallas(freezes, fam):
    """``mlp_block_ref`` from int16 rows (``norm2_in`` 16) to int8
    (``att_block_out`` 8), the LN on the 16-bit stream with the freeze's
    shift, in the kernel and hoisted, against ``mlp_block_p`` in interpret
    mode."""
    jspec = freezes[fam]
    blk = jax.device_get(jspec.params)["blocks"][0]
    c = jspec.config.embed_dim
    x = np.clip(np.round(np.random.default_rng(2).normal(0, 2**13, (B * NP, c))),
                -2**15, 2**15 - 1).astype(np.int16)
    ln_in = np.asarray(jvit._hoisted_ln8(
        jspec.config, jnp.asarray(x), blk["ln2_bias_int"], blk["ln2_shift"],
        blk["s_ln2"], blk["m_ln2"]))
    for fast, hoisted in ((False, False), (True, True)):
        flags = dict(ln_base=fam, gelu_base=fam, fast_exp=fast, fast_poly=fast,
                     mlp_bits=8, out_bits=8)
        li = ln_in if hoisted else None
        want = jblk.mlp_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln2"]),
                                out_dtype=jnp.int8, interpret=True,
                                ln_in=None if li is None else jnp.asarray(li),
                                **flags, **_kw(blk, MLP_KEYS, jnp.asarray))
        got = kb.mlp_block(torch.from_numpy(x),
                           ln_in=None if li is None else torch.from_numpy(li),
                           **flags, **_kw(blk, MLP_KEYS, torch.as_tensor))
        assert got.dtype == torch.int8
        _eq(got.numpy(), want)


# --- (c) the synthetic INT16 spec ----------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_int16_synthetic_spec_has_the_freeze_tree(freezes, fam):
    jspec = freezes[fam]
    small = synthetic_spec(_to_port(jspec).config, seed=0)
    assert _tree(small.params) == _tree(jax.device_get(jspec.params))
    jc, sc = dataclasses.asdict(jspec.config), dataclasses.asdict(small.config)
    assert list(jc.pop("bitwidths").values()) == list(sc.pop("bitwidths").values())
    jc.pop("use_lut"), sc.pop("use_lut")    # no LUTs in the synthetic spec
    assert sc == jc


def test_deit_small_width_int16_synthetic_matches_jax():
    """DeiT-S width at 224 px, the ibert INT16 spec (an ibert LN on the
    16-bit norm2 stream, whose overflow shift is 2): JAX's unfused engine
    and the port's unfused and fused paths give the same logits (its
    ``"ops"`` path runs the ibert family unfused)."""
    spec = synthetic_spec(deit_small_config(depth=1, bitwidths=INT16), seed=0)
    blk = spec.params["blocks"][0]
    assert (float(blk["ln1_shift"]), float(blk["ln2_shift"])) == (0.0, 2.0)
    x = _images(2, 224, seed=5)
    want = _jax_forward(_to_jax(spec), x, False)
    for path in (False, True):
        _eq(engine_forward(spec, x, kernels=path, device="cpu").numpy(), want)
    assert np.isfinite(want).all() and want.std(axis=0).max() > 0


# --- (d) one-hot rows and the P v split ------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
def test_one_hot_rows_saturate_as_jax(freezes, bits):
    """The card's edge inputs on the ibert freeze's block: a one-hot row's
    ``exp16 * factor`` rounds to 2**32 in f32, so its probability is
    2**(bits - 1) before the conversion.  The port's probabilities (plain
    kernel version and unfused engine) equal JAX's unfused ``_softmax_int``,
    which saturates; at 8 bits the port's ``attn_block_ref`` also equals
    JAX's ``attn_block_p`` (interpret mode), whose int8 cast saturates;
    at 16 bits ``_ctx_dot`` splits p = 2**15 into hi = 128, which its int8
    cast wraps to -128: the JAX kernel's product is -2**15 v."""
    jspec = freezes["ibert"]
    blk = {k: torch.as_tensor(np.array(v)) for k, v in
           jax.device_get(jspec.params)["blocks"][0].items()}
    x, ln_in, over = int16_edge_inputs(torch, blk, 2, B, NP, NV, "cpu")
    kw = _kw(blk, ATTN_KEYS, lambda t: t) | over | dict(
        ln_base="ibert", sm_base="ibert", fast_exp=True, fast_poly=True,
        num_heads=2, n_valid=NV, sm_bit=bits, out_bits=bits)
    q = x.reshape(B, NP, 2, 32).permute(0, 2, 1, 3)
    s = kb._requant(kb.int8_matmul(q, q.transpose(-1, -2)), kw["m_attn"], 8)
    raw = kb._softmax_probs(s, "ibert", kw["s_attn"], kw["s_exp_act"], bits, NV,
                            True, True)
    assert raw.max().item() == 2 ** (bits - 1)
    probs = kb.to_container(raw, bits)
    assert probs.max().item() == 2 ** (bits - 1) - 1
    jcfg = dataclasses.replace(jspec.config, bitwidths=dataclasses.replace(
        jspec.config.bitwidths, softmax=bits))
    want = jvit._softmax_int(jcfg, {k: jnp.asarray(v.numpy()) for k, v in kw.items()
                                    if k in ("s_attn", "s_exp_act")},
                             jnp.asarray(s[..., :NV].numpy()), pallas=False)
    _eq(probs[..., :NV].numpy(), want)
    cfg = dataclasses.replace(_to_port(jspec).config, bitwidths=BitWidths(
        **{**dataclasses.asdict(BitWidths()), "softmax": bits}))
    _eq(tvit._softmax_int(cfg, kw, s[..., :NV]).numpy(), want)
    got = kb.attn_block(x, ln_in=ln_in, **kw)
    if bits == 8:
        jkw = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        want = jblk.attn_block_p(jnp.asarray(x.numpy()), s_ln=jnp.asarray(
            np.array(jax.device_get(jspec.params)["blocks"][0]["s_ln1"])),
            ln_in=jnp.asarray(ln_in.numpy()), interpret=True, **jkw)
        _eq(got.numpy()[:, :NV], np.asarray(want)[:, :NV])
    else:
        v = jnp.arange(-128, 128, dtype=jnp.int8)[None, :]
        ctx = jblk._ctx_dot(jnp.full((1, 1), 2.0**15, jnp.float32), v, 16)
        _eq(ctx, -(2**15) * np.arange(-128, 128)[None, :])



def test_pv_split_of_16bit_probabilities_is_exact():
    """The attention kernels take a 16-bit probability p into P v as
    ``hi = p >> 8`` (s8 A operand) and ``lo = p & 255`` (u8 A operand) and
    sum ``((hi v) << 8) + lo v`` in int32 (``csrc/attn_chain.cuh``
    ``attn_tile``): equal to p v for every p in [0, 2**15 - 1] and v in
    [-128, 127], and both parts fit their 8-bit operands."""
    p = np.arange(2**15, dtype=np.int32)[:, None]
    v = np.arange(-128, 128, dtype=np.int32)[None, :]
    hi, lo = p >> 8, p & 255
    assert hi.min() >= 0 and hi.max() <= 127 and lo.min() >= 0 and lo.max() <= 255
    split = ((hi.astype(np.int8).astype(np.int32) * v) << 8) \
        + lo.astype(np.uint8).astype(np.int32) * v
    np.testing.assert_array_equal(split, p * v)
