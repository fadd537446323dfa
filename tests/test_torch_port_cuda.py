"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one: a hand-written
kernel has no CPU mode.  The file imports nothing of JAX, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

(``--noconftest``: the suite's conftest pins JAX to the CPU.)  Shapes are
small: B 2, Np 24 of which n_valid 17 real tokens, C 64, 2 heads, MLP 256
for the block kernels, the shapes of ``tests/test_pallas.py`` for the
standalone ones, and Shiftmax at the edges of its row tiles (row counts
1 to 1,537, N 1 to 1,024, a base off the 16-byte alignment, n_valid 1 and
N - 1, 2- to 16-bit probabilities, x0 below -2**13, flat rows whose exp
sum wraps past 2**31); for Swin, a 56 px Swin-T-width spec (C 96 and 192, heads 3
and 6, windows of 49 tokens, a shifted block) and one at C 384 and 768
(hidden 3072); and edge shapes of the attention kernels' 16-row query
tiles, 32-key chunks and 32-channel head chunks at C 128 (head dims 32, 64
and 128): ViT token counts 1, 15, 17, 33 and 256 with padding tokens, Swin
windows of 49 and 64 tokens, shifted and unshifted, int16 and int8 input.
The MLP kernel also runs at the widths of every model it serves (C /
hidden 96/384 to 1024/4096: the 64-row wgmma block and the 32-row block),
ragged row counts 1, 63 and 65, int8 and int16 streams, and once at
DeiT-S's 50,432 rows; ShiftGELU at GELU scales far from the engines'.
The ppoly GELU and softmax run in both ViT kernels, both Swin kernels
(shifted windows, whose masked scores leave the exp table), every MLP
width, with fast-div patches that fire, one segment, and through the
engines.  The reference's INT16 configuration (bitwidths
``8,8,8,8,16,8,16,8``) runs its variants: ``attn_block`` at 16-bit
probabilities with an int16 output for the three softmaxes (head dims 32
and 128), ``mlp_block`` from int16 rows to int8 at every MLP width, the
attention core's edges (a one-hot row, v at -128 and 127, flat rows, hot
padding keys) at 8 and 16 bits, the INT16 engines; a float-family engine
runs no kernel, as JAX routes it.  The DeiT-S and Swin-T shapes are held
by ``chip_smoke.py``.  The QAT sims, ViT and Swin (56 px at Swin-T's
widths), calibrate and freeze on the card as on the CPU and their logits
equal the kernel engine's; the server's answers equal ``Engine(spec)``'s
on the card; ``Trainer`` over a PNG ImageFolder calibrates on the card as
on the CPU, trains an epoch and resumes from its checkpoint; the native
eval preprocess library builds from ``native/preproc.cpp``.  The freeze-time
table forms (``IVIT_LUT``) of the three block kernels run against their
plain versions and their towers (a freeze's tables from
``synthetic.with_tables``; 8- and 16-bit probabilities, both ivit row sums,
shifted Swin blocks with ``sm_sat``, changed tables, the attention tiles'
edges, the engines), and the integer-sqrt ibert LN in all three kernels
on rows where it differs from floor(sqrt).  ``Engine(spec)`` takes the
H100 table of ``engine/dispatch.py`` (``probe_images``: its timed probe)
and Swin's ``fuse_parts`` launch the half-blocks they name.  The Swin
window attention on the token-order stream (``grid``: the roll and window
partition as the kernel's row map) equals the windowed call between the
roll and partition copies, and a bad grid raises.  The program's
spans line up with the profiler's device trace.  Exact
equality, but for
the float family's logits against the CPU's (``tests/test_torch_port_float.py``'s bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ivit_tpu_torch.engine import Engine
from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                              synthetic_spec, synthetic_swin_spec)
from ivit_tpu_torch.models import BitWidths
from ivit_tpu_torch.models import swin as tgeo
from ivit_tpu_torch.ops.kernels import block as kb
from ivit_tpu_torch.ops.kernels import nonlinear as knl

pytestmark = pytest.mark.cuda

B, NP, NV, C, HEADS = 2, 24, 17, 64, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (gelu, softmax, ln)
MIXES = [("ivit", "ivit", "ivit"), ("ivit", "ivit", "ibert"),
         ("ibert", "ibert", "ivit")]


def _small_config(depth, mix=("ibert", "ibert", "ibert")):
    gelu, softmax, ln = mix
    return dataclasses.replace(
        deit_small_config(depth=depth, img_size=64, ln=ln, gelu=gelu,
                          softmax=softmax),
        embed_dim=C, num_heads=HEADS, num_classes=10)


def _block(dev, mix=("ibert", "ibert", "ibert")):
    blk = synthetic_spec(_small_config(1, mix), seed=3).params["blocks"][0]
    return {k: torch.as_tensor(v).to(dev) for k, v in blk.items()}


def _x(dev):
    x = np.clip(np.round(np.random.default_rng(0).normal(0, 32, (B, NP, C))),
                -128, 127).astype(np.int8)
    x[:, NV:] = 0
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("fast", [False, True])
def test_cuda_kernels_match_plain_versions(cuda, fast):
    b, x = _block(cuda), _x(cuda)
    kw = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
              qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
              m_attn=b["m_attn"], s_attn=b["s_attn"], s_exp_act=b["s_exp_act"],
              m_av=b["m_av"], proj_w=b["proj_w"], proj_b=b["proj_b"],
              m_proj=b["m_proj"], m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
              num_heads=HEADS, n_valid=NV, fast_exp=fast, fast_poly=fast)
    got = kb.attn_block(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :NV], kb.attn_block_ref(x, **kw)[:, :NV])

    x2 = x.reshape(B * NP, C)
    kw = dict(ln_bias=b["ln2_bias_int"], m_ln=b["m_ln2"], ln_shift=b["ln2_shift"],
              fc1_w=b["fc1_w"], fc1_b=b["fc1_b"], m_fc1=b["m_fc1"],
              s_gelu=b["s_gelu"], m_gelu=b["m_gelu"], fc2_w=b["fc2_w"],
              fc2_b=b["fc2_b"], m_fc2=b["m_fc2"], m_res_x=b["m_res2_x"],
              m_res_id=b["m_res2_id"], fast_poly=fast)
    got = kb.mlp_block(x2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, kb.mlp_block_ref(x2, **kw))


def test_cuda_engine_matches_plain_engines(cuda):
    spec = synthetic_spec(_small_config(2), seed=0)
    images = np.random.default_rng(1).normal(size=(4, 64, 64, 3)).astype(np.float32)
    kb.mlp_block.launches = kb.attn_block.launches = knl.ln_requant.launches = 0
    got = Engine(spec)(images)
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.attn_block.launches) == (2, 2)
    assert knl.ln_requant.launches == 1
    assert torch.equal(got, Engine(spec, kernels=False)(images))
    assert torch.equal(got.cpu(), Engine(spec, device="cpu", kernels=False)(images))


@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("mix", MIXES, ids=["/".join(m) for m in MIXES])
def test_cuda_ivit_block_kernels_match_plain_versions(cuda, mix, hoisted):
    gelu, softmax, ln = mix
    b, x = _block(cuda, mix), _x(cuda)
    for fast in (False, True):
        kw = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"],
                  ln_shift=b["ln1_shift"], qkv_w=b["qkv_w"], qkv_b=b["qkv_b"],
                  m_qkv=b["m_qkv"], m_attn=b["m_attn"], s_attn=b["s_attn"],
                  s_exp_act=b.get("s_exp_act"), m_av=b["m_av"],
                  proj_w=b["proj_w"], proj_b=b["proj_b"], m_proj=b["m_proj"],
                  m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
                  num_heads=HEADS, n_valid=NV, fast_exp=fast, fast_poly=fast,
                  ln_base=ln, sm_base=softmax)
        if hoisted:
            kw["ln_in"] = kb._ln8(x, ln, b["ln1_bias_int"], b["ln1_shift"],
                                  b["m_ln1"], None)
        got = kb.attn_block(x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[:, :NV], kb.attn_block_ref(x, **kw)[:, :NV])

        x2 = x.reshape(B * NP, C)
        kw = dict(ln_bias=b["ln2_bias_int"], m_ln=b["m_ln2"],
                  ln_shift=b["ln2_shift"], fc1_w=b["fc1_w"], fc1_b=b["fc1_b"],
                  m_fc1=b["m_fc1"], s_gelu=b["s_gelu"], m_gelu=b["m_gelu"],
                  fc2_w=b["fc2_w"], fc2_b=b["fc2_b"], m_fc2=b["m_fc2"],
                  m_res_x=b["m_res2_x"], m_res_id=b["m_res2_id"],
                  fast_exp=fast, fast_poly=fast, ln_base=ln, gelu_base=gelu)
        if hoisted:
            kw["ln_in"] = kb._ln8(x2, ln, b["ln2_bias_int"], b["ln2_shift"],
                                  b["m_ln2"], None)
        got = kb.mlp_block(x2, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, kb.mlp_block_ref(x2, **kw))


def _at_byte_offset(t, offset):
    """A contiguous copy of ``t`` whose base lies ``offset`` bytes past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("shape,s,bit,n_valid,flat", [
    *[(*case, False) for case in [
        ((4, 6, 37, 197), 0.0521371, 8, None), ((130, 50), 0.061, 8, None),
        ((16, 197), 0.0521371, 16, None), ((4, 6, 37, 197), 0.0045778966, 8, 180),
        ((3, 700), 0.02, 8, 650),
        # one column at x0 = -1: probability 2**(bits - 1), saturated
        ((4, 1), 2.0, 8, None), ((4, 1), 2.0, 16, None),
        # the tiles' edges: row counts off the 32-row (N <= 224) and 16-row
        # tiles, widths about the 224-column split and 256, n_valid 1 and
        # N - 1, bits 2 and 15, x0 = -10,000 and -33,334 (past the int32
        # exp's -2**13)
        ((1, 197), 0.0521371, 8, None), ((15, 197), 1e-4, 15, 196),
        ((17, 16), 0.061, 2, 1), ((1537, 197), 0.0521371, 8, 196),
        ((1537, 197), 3e-5, 16, None), ((33, 1), 0.061, 15, None),
        ((17, 224), 0.061, 8, 223), ((17, 225), 1e-4, 16, None),
        ((17, 256), 3e-5, 8, 255), ((15, 257), 0.061, 16, 1),
        ((1537, 257), 0.0521371, 2, None), ((17, 1024), 1e-4, 8, 1023),
        ((1, 1024), 0.061, 16, None)]],
    # flat rows whose exps sum past 2**31: the high limbs' int32 sum wraps,
    # as in the reference, and the probabilities come out negative
    *[(shape, s, bit, None, True) for shape, s in (((3, 700), 3e-5), ((17, 1024), 5e-5))
      for bit in (8, 16)]])
def test_cuda_shiftmax_matches_plain_version(cuda, shape, s, bit, n_valid, flat):
    """Both quotient forms, each from a 16-byte-aligned base (whole tiles
    by bulk copies) and from one a byte past it (the byte path)."""
    if flat:
        scores = torch.full(shape, 5, dtype=torch.int8, device=cuda)
    else:
        scores = torch.from_numpy(np.random.default_rng(0).integers(
            -128, 128, shape).astype(np.int8)).to(cuda)
    s = torch.tensor(s, dtype=torch.float32, device=cuda)
    for fast_q in (False, True):
        want = knl.shiftmax_ref(scores, s, bit, n_valid=n_valid, fast_q=fast_q)
        if flat:
            assert (want < 0).all()
        for offset in (0, 1):
            x = _at_byte_offset(scores, offset)
            assert x.data_ptr() % 16 == offset
            before = knl.shiftmax.launches
            got = knl.shiftmax(x, s, bit, n_valid=n_valid, fast_q=fast_q)
            torch.cuda.synchronize()
            assert knl.shiftmax.launches == before + 1
            assert torch.equal(got, want), (fast_q, offset)


@pytest.mark.parametrize("shape,s,m_out", [((64, 384), 0.0417093, 0.031727),
                                           ((2, 17, 1536), 0.014047618, 0.5),
                                           ((5, 30), 0.0417093, 0.031727),
                                           ((9, 2048), 0.014047618, 0.031727),
                                           ((3, 4096), 0.0417093, 0.5),
                                           ((3, 4112), 0.0417093, 0.031727),
                                           ((7, 100), 0.014047618, 0.031727),
                                           ((33, 1536), 1e-3, 0.031727),
                                           ((33, 1536), 1.0, 0.031727)])
def test_cuda_shift_gelu_requant_matches_plain_version(cuda, shape, s, m_out):
    """Rows held in registers (whole 16-byte chunks, up to 4096), rows read
    a word or a byte a lane, and GELU scales far from the engines'."""
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -127, 128, shape).astype(np.int8)).to(cuda)
    s = torch.tensor(s, dtype=torch.float32, device=cuda)
    m_out = torch.tensor(m_out, dtype=torch.float32, device=cuda)
    for fast_q in (False, True):
        before = knl.shift_gelu_requant.launches
        got = knl.shift_gelu_requant(x, s, m_out, 8, fast_q=fast_q)
        torch.cuda.synchronize()
        assert knl.shift_gelu_requant.launches == before + 1
        assert torch.equal(got, knl.shift_gelu_requant_ref(x, s, m_out, 8,
                                                           fast_q=fast_q))


def test_cuda_ivit_engine_paths_match_plain_engines(cuda):
    spec = synthetic_spec(_small_config(2, ("ivit", "ivit", "ivit")), seed=0)
    images = np.random.default_rng(1).normal(size=(4, 64, 64, 3)).astype(np.float32)
    want = Engine(spec, kernels=False)(images)
    kb.mlp_block.launches = kb.attn_block.launches = 0
    knl.shiftmax.launches = knl.shift_gelu_requant.launches = 0
    assert torch.equal(Engine(spec)(images), want)
    assert torch.equal(Engine(spec, kernels="ops")(images), want)
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.attn_block.launches) == (2, 2)
    assert (knl.shiftmax.launches, knl.shift_gelu_requant.launches) == (2, 2)
    assert torch.equal(want.cpu(), Engine(spec, device="cpu", kernels=False)(images))


# (gelu, softmax, ln): ibert, ivit and the two mixes
SWIN_MIXES = [("ibert", "ibert", "ibert")] + MIXES


def _swin_spec(mix, embed_dim=96, heads=(3, 6), depths=(2, 2)):
    gelu, softmax, ln = mix
    return synthetic_swin_spec(swin_tiny_config(
        depths=depths, img_size=56, embed_dim=embed_dim, stage_heads=heads,
        num_classes=10, gelu=gelu, softmax=softmax, ln=ln), seed=3)


def _swin_blocks(spec, dev, grid=14):
    """(block tensors, heads, windows an image, shift) of every block; grid:
    the patch grid of the spec's image size."""
    out, ws = [], spec.config.window_size
    for (kind, stage, shift), blk in zip(spec.config.layout, spec.params["blocks"]):
        if kind == "block":
            res = grid // 2 ** stage
            out.append(({k: torch.as_tensor(v).to(dev) for k, v in blk.items()},
                        spec.config.stage_heads[stage], (res // min(ws, res)) ** 2,
                        shift))
    return out


def _stream(dev, shape, bits, seed):
    lim = 2 ** (bits - 1)
    x = np.clip(np.round(np.random.default_rng(seed).normal(0, lim / 4, shape)),
                -lim, lim - 1)
    return torch.from_numpy(x.astype(np.int16 if bits > 8 else np.int8)).to(dev)


def _swin_attn_kw(b, mix, fast, heads, n_windows, shift):
    return dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
                qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
                m_attn=b["m_attn"], m_attn2=b["m_attn2"], s_attn=b["s_attn"],
                rel_addend=b["rel_bias_addend"],
                mask_addend=b["mask_int"] if shift else None,
                s_exp_act=b.get("s_exp_act"), m_av=b["m_av"], proj_w=b["proj_w"],
                proj_b=b["proj_b"], m_proj=b["m_proj"], m_res_x=b["m_res1_x"],
                m_res_id=b["m_res1_id"], num_heads=heads, n_windows=n_windows,
                fast_exp=fast, fast_poly=fast, sm_base=mix[1], ln_base=mix[2])


def _swin_mlp_kw(b, mix, fast):
    return dict(ln_bias=b["ln2_bias_int"], m_ln=b["m_ln2"], ln_shift=b["ln2_shift"],
                fc1_w=b["fc1_w"], fc1_b=b["fc1_b"], m_fc1=b["m_fc1"],
                s_gelu=b["s_gelu"], m_gelu=b["m_gelu"], fc2_w=b["fc2_w"],
                fc2_b=b["fc2_b"], m_fc2=b["m_fc2"], m_res_x=b["m_res2_x"],
                m_res_id=b["m_res2_id"], mlp_bits=8, out_bits=16, fast_exp=fast,
                fast_poly=fast, ln_base=mix[2], gelu_base=mix[0])


@pytest.mark.parametrize("mix", SWIN_MIXES, ids=["/".join(m) for m in SWIN_MIXES])
def test_cuda_swin_kernels_match_plain_versions(cuda, mix):
    """Both Swin kernels at C 96 (a shifted and an unshifted block) and 192,
    int16 and int8 (a merge's output) window input, fast flags both ways,
    the LN in the kernel and hoisted; ibert LNs carry a shift > 0 here."""
    for i, (b, heads, nw, shift) in enumerate(_swin_blocks(_swin_spec(mix), cuda)):
        c = b["ln1_bias_int"].shape[0]
        for bits in (16, 8):
            x = _stream(cuda, (2 * nw, 49, c), bits, seed=i)
            for fast in (False, True):
                kw = _swin_attn_kw(b, mix, fast, heads, nw, shift)
                for ln_in in (None, kb._ln8(x, mix[2], kw["ln_bias"],
                                            kw["ln_shift"], kw["m_ln"], None)):
                    before = kb.swin_attn_block.launches
                    got = kb.swin_attn_block(x, ln_in=ln_in, **kw)
                    torch.cuda.synchronize()
                    assert kb.swin_attn_block.launches == before + 1
                    want = kb.swin_attn_block_ref(x, ln_in=ln_in, **kw)
                    assert got.dtype == torch.int16
                    assert torch.equal(got, want), (i, bits, fast, ln_in is None)
        x = _stream(cuda, (2 * nw * 49, c), 16, seed=10 + i)
        for fast in (False, True):
            kw = _swin_mlp_kw(b, mix, fast)
            got = kb.mlp_block(x, **kw)
            torch.cuda.synchronize()
            assert got.dtype == torch.int16
            assert torch.equal(got, kb.mlp_block_ref(x, **kw)), (i, fast)


def test_cuda_swin_wide_stages_match_plain_versions(cuda):
    """C 384 and 768 with hidden 1536 and 3072 (the 32-row MLP tile), 12 and
    24 heads of 32 channels."""
    mix = ("ivit", "ivit", "ivit")
    spec = _swin_spec(mix, embed_dim=384, heads=(12, 24), depths=(1, 1))
    for i, (b, heads, nw, shift) in enumerate(_swin_blocks(spec, cuda)):
        c = b["ln1_bias_int"].shape[0]
        x = _stream(cuda, (2 * nw, 49, c), 16, seed=20 + i)
        kw = _swin_attn_kw(b, mix, True, heads, nw, shift)
        got = kb.swin_attn_block(x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, kb.swin_attn_block_ref(x, **kw))
        x = x.reshape(-1, c)
        got = kb.mlp_block(x, **_swin_mlp_kw(b, mix, True))
        torch.cuda.synchronize()
        assert torch.equal(got, kb.mlp_block_ref(x, **_swin_mlp_kw(b, mix, True)))


def test_cuda_swin_engine_matches_plain_engines(cuda):
    spec = _swin_spec(("ivit", "ivit", "ivit"))
    images = np.random.default_rng(1).normal(size=(3, 56, 56, 3)).astype(np.float32)
    want = Engine(spec, kernels=False)(images)
    kb.mlp_block.launches = kb.swin_attn_block.launches = knl.ln_requant.launches = 0
    kb.swin_attn_block.token_order_launches = 0
    got = Engine(spec)(images)
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.swin_attn_block.launches) == (4, 4)
    assert kb.swin_attn_block.token_order_launches == 4   # no roll or partition copy
    assert knl.ln_requant.launches == 3      # patch norm, merge, final norm
    assert torch.equal(got, want)
    assert torch.equal(Engine(spec, stage_paths=(True, False))(images), want)
    assert torch.equal(want.cpu(), Engine(spec, device="cpu", kernels=False)(images))


def _token_order_pair(x, kw, res, shift, ln_in=None, ws=7):
    """The call on the token-order stream x [B, res*res, C] (``grid``: the
    kernel's row map) and, on the card too, the windowed call between the
    roll + partition and reverse + roll copies that the engine ran before;
    one token-order launch."""
    b, _, c = x.shape
    before = kb.swin_attn_block.token_order_launches
    got = kb.swin_attn_block(x, ln_in=ln_in, grid=(res, ws, shift), **kw)
    torch.cuda.synchronize()
    assert kb.swin_attn_block.token_order_launches == before + 1
    assert got.dtype == torch.int16 and got.shape == x.shape

    def win(t):
        return None if t is None else tgeo.to_windows(t, b, res, c, ws, shift)
    want = kb.swin_attn_block(win(x), ln_in=win(ln_in), **kw)
    return got, tgeo.from_windows(want, b, res, c, ws, shift)


IVIT3, IBERT3 = ("ivit",) * 3, ("ibert",) * 3
# (spec families, block of _swin_blocks, stream bits, ln_in, tables): the
# 56 px spec's stage 0 (res 14, 4 windows an image; block 1 shifted by 3)
# and stage 1 (res = ws = 7; block 2 a merge's int8 output)
TOKEN_ORDER_CASES = {
    "ivit_shifted_int16": (IVIT3, 1, 16, False, False),
    "ivit_unshifted_int16": (IVIT3, 0, 16, False, False),
    "ivit_shifted_int8": (IVIT3, 1, 8, False, False),
    "ivit_merge_int8_res_eq_ws": (IVIT3, 2, 8, False, False),
    "ivit_res_eq_ws_int16": (IVIT3, 3, 16, False, False),
    "ibert_shifted": (IBERT3, 1, 16, False, False),
    "mix_ibert_ln_shifted": (("ivit", "ivit", "ibert"), 1, 16, False, False),
    "ivit_ln_in_shifted": (IVIT3, 1, 16, True, False),
    "ibert_ln_in_shifted": (IBERT3, 1, 16, True, False),
    "ivit_tables_sm_sat_shifted": (IVIT3, 1, 16, False, True),
    "ibert_tables_sm_sat_shifted": (IBERT3, 1, 16, False, True),
    "ibert_tables_unshifted": (IBERT3, 0, 16, False, True),
}


@pytest.mark.parametrize("case", list(TOKEN_ORDER_CASES))
def test_cuda_swin_token_order_matches_windowed_call(cuda, case, monkeypatch):
    """``swin_attn_block`` on the token-order stream equals the windowed
    call between the roll and partition copies, bit for bit: Swin-T's
    widths (C 96 and 192, windows of 49), shifted and unshifted, int16 and
    int8, res = ws, the ibert and ivit LNs with ``ln_in``, the table forms
    with ``sm_sat`` on a shifted block."""
    from ivit_tpu_torch.engine.synthetic import with_tables
    mix, i, bits, hoisted, tables = TOKEN_ORDER_CASES[case]
    spec = _swin_spec(mix)
    if tables:
        spec = with_tables(spec)
        monkeypatch.setenv("IVIT_LUT", "1")
    b, heads, nw, shift = _swin_blocks(spec, cuda)[i]
    res, c = 7 * int(round(nw ** 0.5)), b["ln1_bias_int"].shape[0]
    x = _stream(cuda, (2, res * res, c), bits, seed=80 + i)
    kw = _swin_attn_kw(b, mix, True, heads, nw, shift)
    if tables:
        kw |= dict(sm_lut=b["sm_lut"], sm_sum_i32=spec.config.sm_sum_i32,
                   sm_sat=b.get("sm_sat"))
        assert ("sm_sat" in b) == (shift > 0)
    ln_in = kb._ln8(x, mix[2], kw["ln_bias"], kw["ln_shift"], kw["m_ln"], None) \
        if hoisted else None
    before = kb.swin_attn_block.lut_launches
    got, want = _token_order_pair(x, kw, res, shift, ln_in)
    assert kb.swin_attn_block.lut_launches == before + 2 * tables
    assert torch.equal(got, want), case
    assert torch.equal(got, kb.swin_attn_block_ref(
        x, ln_in=ln_in, grid=(res, 7, shift), **kw)), case


def test_cuda_swin_attn_block_refuses_a_bad_grid(cuda):
    """A grid that does not tile the stream raises, and nothing launches."""
    b, heads, nw, shift = _swin_blocks(_swin_spec(IVIT3), cuda)[1]
    kw = _swin_attn_kw(b, IVIT3, True, heads, nw, shift)
    x = _stream(cuda, (2, 196, 96), 16, seed=0)
    before = kb.swin_attn_block.launches
    for grid in ((14, 7, 7), (14, 5, 0), (13, 7, 3), (14, 14, 0)):
        with pytest.raises(ValueError, match="grid"):
            kb.swin_attn_block(x, grid=grid, **kw)
    with pytest.raises(ValueError, match="grid"):
        kb.swin_attn_block(x, grid=(14, 7, 3), **(kw | dict(n_windows=1)))
    assert kb.swin_attn_block.launches == before


# (Np, n_valid) and heads at C 128 (head dims 32, 64, 128): ragged query
# tiles, key chunks and padding keys of the attention cores
EDGE_TOKENS = [(1, 1), (15, 13), (17, 15), (33, 31), (256, 250)]
EDGE_HEADS = [4, 2, 1]


@pytest.mark.parametrize("heads", EDGE_HEADS, ids=[f"dh{128 // h}" for h in EDGE_HEADS])
@pytest.mark.parametrize("family", ["ivit", "ibert"])
def test_cuda_attn_block_edge_shapes(cuda, family, heads):
    cfg = dataclasses.replace(
        deit_small_config(depth=1, img_size=64, ln=family, gelu=family,
                          softmax=family),
        embed_dim=128, num_heads=heads, num_classes=10)
    b = {k: torch.as_tensor(v).to(cuda)
         for k, v in synthetic_spec(cfg, seed=5).params["blocks"][0].items()}
    for i, (np_, nv) in enumerate(EDGE_TOKENS):
        x = _stream(cuda, (2, np_, 128), 8, seed=30 + i)
        kw = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
                  qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
                  m_attn=b["m_attn"], s_attn=b["s_attn"], s_exp_act=b.get("s_exp_act"),
                  m_av=b["m_av"], proj_w=b["proj_w"], proj_b=b["proj_b"],
                  m_proj=b["m_proj"], m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
                  num_heads=heads, n_valid=nv, fast_exp=True, fast_poly=True,
                  ln_base=family, sm_base=family)
        for ln_in in (None, kb._ln8(x, family, kw["ln_bias"], kw["ln_shift"],
                                    kw["m_ln"], None)):
            got = kb.attn_block(x, ln_in=ln_in, **kw)
            torch.cuda.synchronize()
            want = kb.attn_block_ref(x, ln_in=ln_in, **kw)
            assert torch.equal(got[:, :nv], want[:, :nv]), (np_, ln_in is None)


@pytest.mark.parametrize("heads", EDGE_HEADS, ids=[f"dh{128 // h}" for h in EDGE_HEADS])
@pytest.mark.parametrize("window", [7, 8], ids=["n49", "n64"])
def test_cuda_swin_attn_block_edge_shapes(cuda, window, heads):
    """Windows of 49 and 64 tokens (4 an image), the unshifted and the
    shifted block, int16 and int8 input, the LN in the kernel and hoisted."""
    for family in ("ivit", "ibert"):
        spec = synthetic_swin_spec(swin_tiny_config(
            depths=(2,), img_size=8 * window, embed_dim=128, stage_heads=(heads,),
            window_size=window, num_classes=10, gelu=family, softmax=family,
            ln=family), seed=5)
        mix = (family, family, family)
        for i, (blk, h, nw, shift) in enumerate(_swin_blocks(spec, cuda, grid=16 if window == 8 else 14)):
            for bits in (16, 8):
                x = _stream(cuda, (2 * nw, window * window, 128), bits, seed=40 + i)
                kw = _swin_attn_kw(blk, mix, True, h, nw, shift)
                for ln_in in (None, kb._ln8(x, family, kw["ln_bias"], kw["ln_shift"],
                                            kw["m_ln"], None)):
                    got = kb.swin_attn_block(x, ln_in=ln_in, **kw)
                    torch.cuda.synchronize()
                    want = kb.swin_attn_block_ref(x, ln_in=ln_in, **kw)
                    assert torch.equal(got, want), (family, shift, bits, ln_in is None)


@pytest.mark.parametrize("s_attn", [2.0, 0.0521371, 1e-4])
@pytest.mark.parametrize("family", ["ivit", "ibert"])
def test_cuda_attn_block_exp_paths(cuda, family, s_attn):
    """Softmax scales that take the cores' int32 exp (0.0521371) and its f32
    form (x0 = -1 at 2.0; past the int32 range at 1e-4)."""
    mix = (family, family, family)
    b, x = _block(cuda, mix), _x(cuda)
    kw = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
              qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
              m_attn=b["m_attn"], s_attn=torch.tensor(s_attn, device=cuda),
              s_exp_act=b.get("s_exp_act"), m_av=b["m_av"], proj_w=b["proj_w"],
              proj_b=b["proj_b"], m_proj=b["m_proj"], m_res_x=b["m_res1_x"],
              m_res_id=b["m_res1_id"], num_heads=HEADS, n_valid=NV,
              fast_exp=True, fast_poly=True, ln_base=family, sm_base=family)
    got = kb.attn_block(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :NV], kb.attn_block_ref(x, **kw)[:, :NV])


# (C, hidden): Swin-T stage 0, stage 1, DeiT-S and Swin-T stage 2 (the
# 64-row wgmma block), Swin-T stage 3 / ViT-B and ViT-L (the 32-row block)
MLP_SHAPES = [(96, 384), (192, 768), (384, 1536), (768, 3072), (1024, 4096)]


def _vit_block_at(dev, c, mix, seed=7):
    gelu, softmax, ln = mix
    cfg = dataclasses.replace(
        deit_small_config(depth=1, img_size=64, ln=ln, gelu=gelu, softmax=softmax),
        embed_dim=c, num_heads=c // 32, num_classes=10)
    blk = synthetic_spec(cfg, seed=seed).params["blocks"][0]
    return {k: torch.as_tensor(v).to(dev) for k, v in blk.items()}


@pytest.mark.parametrize("c,hidden", MLP_SHAPES, ids=[f"C{c}" for c, _ in MLP_SHAPES])
def test_cuda_mlp_block_widths(cuda, c, hidden):
    """Row counts 1, 63 and 65 (ragged row blocks of both kernels), the int8
    stream and the int16 one (fc2 at 8 bits, out at 16, as Swin runs it),
    the LN in the kernel and hoisted, every family mix, fast flags both
    ways."""
    for mix in SWIN_MIXES:
        b = _vit_block_at(cuda, c, mix)
        assert tuple(b["fc1_w"].shape) == (c, hidden)
        for r in (1, 63, 65):
            for bits in (8, 16):
                x = _stream(cuda, (r, c), bits, seed=r)
                for fast in (False, True):
                    kw = _swin_mlp_kw(b, mix, fast) | dict(out_bits=bits)
                    for ln_in in (None, kb._ln8(x, mix[2], kw["ln_bias"],
                                                kw["ln_shift"], kw["m_ln"], None)):
                        before = kb.mlp_block.launches
                        got = kb.mlp_block(x, ln_in=ln_in, **kw)
                        torch.cuda.synchronize()
                        assert kb.mlp_block.launches == before + 1
                        want = kb.mlp_block_ref(x, ln_in=ln_in, **kw)
                        assert torch.equal(got, want), (mix, r, bits, fast, ln_in is None)


@pytest.mark.parametrize("family", ["ivit", "ibert"])
def test_cuda_mlp_block_deit_s_rows(cuda, family):
    """DeiT-S's 256 x 197 token rows, with the engine's pre-transposed
    weights and without."""
    b = _vit_block_at(cuda, 384, (family, family, family))
    x = _stream(cuda, (256 * 197, 384), 8, seed=5)
    kw = _swin_mlp_kw(b, (family,) * 3, True) | dict(out_bits=8)
    want = kb.mlp_block_ref(x, **kw)
    for wt in (False, True):
        extra = dict(fc1_wt=b["fc1_w"].t().contiguous(),
                     fc2_wt=b["fc2_w"].t().contiguous()) if wt else {}
        got = kb.mlp_block(x, **kw, **extra)
        torch.cuda.synchronize()
        assert torch.equal(got, want), wt


@pytest.mark.parametrize("s_gelu", [1e-3, 0.0417093, 1.0])
def test_cuda_mlp_block_gelu_scales(cuda, s_gelu):
    """ShiftGELU's table at GELU scales far from the engines' (the exp's
    quotient x / x0 from 0 to hundreds), both block kernels."""
    mix = ("ivit", "ivit", "ivit")
    for c in (64, 768):
        b = _vit_block_at(cuda, c, mix)
        x = _stream(cuda, (65, c), 8, seed=9)
        for fast in (False, True):
            kw = _swin_mlp_kw(b, mix, fast) | dict(
                out_bits=8, s_gelu=torch.tensor(s_gelu, device=cuda))
            got = kb.mlp_block(x, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, kb.mlp_block_ref(x, **kw)), (c, fast)


# --- the ppoly family ----------------------------------------------------------

# the ibert backend at the fit's defaults (16 segments of degree 2), without
# its boundary search (seconds a site on the host); the float backend at 5
# segments of degree 3
PPOLY_FAMILIES = ["ppoly_backend_ibert_optim-bounds_false",
                  "ppoly_backend_float_deg_3_seg_5_optim-bounds_false"]


def _ppoly_gelu_kw(b, fastdiv):
    return dict(gelu_bounds=b["gelu_bounds"], gelu_coeffs=b["gelu_coeffs"],
                gelu_s_out=b["gelu_s_out"], gelu_fastdiv=fastdiv,
                gelu_s_out_c=b["gelu_s_out_c"], gelu_patch_h=b["gelu_patch_h"],
                gelu_patch_d=b["gelu_patch_d"])


def _ppoly_sm_kw(b):
    return dict(sm_bounds=b["sm_bounds"], sm_coeffs=b["sm_coeffs"], exp_bits=16)


@pytest.mark.parametrize("ln", ["ibert", "ivit"])
@pytest.mark.parametrize("fam", PPOLY_FAMILIES, ids=["ibert16x2", "float5x3"])
def test_cuda_ppoly_block_kernels_match_plain_versions(cuda, fam, ln):
    """Both ViT block kernels with the ppoly GELU (fast-div and rdiv forms)
    and softmax (padding tokens), C 64, the LN in the kernel and hoisted."""
    mix = ("ppoly", "ppoly", ln)
    b = {k: torch.as_tensor(v).to(cuda) for k, v in synthetic_spec(
        _small_config(1, (fam, fam, ln)), seed=3).params["blocks"][0].items()}
    x = _x(cuda)
    kw = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
              qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
              m_attn=b["m_attn"], s_attn=b["s_attn"], m_av=b["m_av"],
              proj_w=b["proj_w"], proj_b=b["proj_b"], m_proj=b["m_proj"],
              m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"], num_heads=HEADS,
              n_valid=NV, sm_base="ppoly", ln_base=ln) | _ppoly_sm_kw(b)
    for ln_in in (None, kb._ln8(x, ln, kw["ln_bias"], kw["ln_shift"], kw["m_ln"], None)):
        got = kb.attn_block(x, ln_in=ln_in, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[:, :NV], kb.attn_block_ref(x, ln_in=ln_in, **kw)[:, :NV])
    x2 = x.reshape(B * NP, C)
    for fastdiv in (True, False):
        kw = _swin_mlp_kw(b, mix, True) | dict(out_bits=8) | _ppoly_gelu_kw(b, fastdiv)
        got = kb.mlp_block(x2, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, kb.mlp_block_ref(x2, **kw)), fastdiv


@pytest.mark.parametrize("c,hidden", MLP_SHAPES, ids=[f"C{c}" for c, _ in MLP_SHAPES])
def test_cuda_ppoly_mlp_block_widths(cuda, c, hidden):
    """The ppoly GELU in both MLP blocks (the 32-row one at hidden 3072 and
    4096), ragged rows, int8 and int16 streams, fast-div on and off."""
    fam = PPOLY_FAMILIES[0]
    b = _vit_block_at(cuda, c, (fam, fam, "ivit"))
    for r in (1, 65):
        for bits in (8, 16):
            x = _stream(cuda, (r, c), bits, seed=r)
            for fastdiv in (True, False):
                kw = _swin_mlp_kw(b, ("ppoly", "ppoly", "ivit"), True) | dict(
                    out_bits=bits) | _ppoly_gelu_kw(b, fastdiv)
                got = kb.mlp_block(x, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, kb.mlp_block_ref(x, **kw)), (r, bits, fastdiv)


def test_cuda_ppoly_gelu_patches_and_limits(cuda):
    """Fast-div patches that fire (inputs -5 and 3, and 8 slots), one
    segment, and the tables the kernels refuse."""
    fam = PPOLY_FAMILIES[0]
    b = _vit_block_at(cuda, 64, (fam, fam, "ivit"))
    x = _stream(cuda, (65, 64), 8, seed=3)
    base = _swin_mlp_kw(b, ("ppoly", "ppoly", "ivit"), True) | dict(out_bits=8)
    ph = torch.tensor([-5.0, 3.0] + [2.0**30] * 6, device=cuda)
    pd = torch.tensor([1.0, -2.0] + [0.0] * 6, device=cuda)
    for extra in (dict(gelu_patch_h=ph, gelu_patch_d=pd),
                  dict(gelu_patch_h=ph[:2].contiguous(), gelu_patch_d=pd[:2].contiguous()),
                  dict(gelu_bounds=b["gelu_bounds"][:0],
                       gelu_coeffs=b["gelu_coeffs"][:1].contiguous())):
        kw = base | _ppoly_gelu_kw(b, True) | extra
        got = kb.mlp_block(x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, kb.mlp_block_ref(x, **kw))
    too_many = torch.zeros((65, 3), device=cuda)
    with pytest.raises(ValueError, match="segments"):
        kb.mlp_block(x, **(base | _ppoly_gelu_kw(b, True) | dict(
            gelu_bounds=torch.zeros(64, dtype=torch.int32, device=cuda),
            gelu_coeffs=too_many)))
    with pytest.raises(ValueError, match="patches"):
        kb.mlp_block(x, **(base | _ppoly_gelu_kw(b, True) | dict(
            gelu_patch_h=torch.zeros(9, device=cuda),
            gelu_patch_d=torch.zeros(9, device=cuda))))


@pytest.mark.parametrize("fam", PPOLY_FAMILIES, ids=["ibert16x2", "float5x3"])
def test_cuda_ppoly_swin_kernels_match_plain_versions(cuda, fam):
    """The ppoly softmax of both window cores at C 96 (shifted: the masked
    scores past the exp table run the polynomial) and 192, int16 and int8
    input; the Swin MLP with the ppoly GELU."""
    mix = ("ppoly", "ppoly", "ivit")
    for i, (b, heads, nw, shift) in enumerate(_swin_blocks(_swin_spec((fam, fam, "ivit")),
                                                           cuda)):
        c = b["ln1_bias_int"].shape[0]
        for bits in (16, 8):
            x = _stream(cuda, (2 * nw, 49, c), bits, seed=i)
            kw = _swin_attn_kw(b, mix, True, heads, nw, shift) | _ppoly_sm_kw(b)
            got = kb.swin_attn_block(x, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, kb.swin_attn_block_ref(x, **kw)), (i, bits)
        x = _stream(cuda, (2 * nw * 49, c), 16, seed=10 + i)
        for fastdiv in (True, False):
            kw = _swin_mlp_kw(b, mix, True) | _ppoly_gelu_kw(b, fastdiv)
            got = kb.mlp_block(x, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, kb.mlp_block_ref(x, **kw)), (i, fastdiv)


def test_cuda_ppoly_engines_match_plain_engines(cuda):
    fam = PPOLY_FAMILIES[0]
    images = np.random.default_rng(1).normal(size=(3, 64, 64, 3)).astype(np.float32)
    spec = synthetic_spec(_small_config(2, (fam, fam, "ibert")), seed=0)
    want = Engine(spec, kernels=False)(images)
    kb.mlp_block.launches = kb.attn_block.launches = knl.ln_requant.launches = 0
    got = Engine(spec)(images)
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.attn_block.launches) == (2, 2)
    assert knl.ln_requant.launches == 1
    assert torch.equal(got, want)
    assert torch.equal(Engine(spec, kernels="ops")(images), want)
    assert torch.equal(want.cpu(), Engine(spec, device="cpu", kernels=False)(images))
    spec = _swin_spec((fam, fam, "ivit"))
    images = images[:, :56, :56].copy()
    want = Engine(spec, kernels=False)(images)
    kb.mlp_block.launches = kb.swin_attn_block.launches = knl.ln_requant.launches = 0
    got = Engine(spec)(images)
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.swin_attn_block.launches) == (4, 4)
    assert knl.ln_requant.launches == 3      # patch norm, merge, final norm
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), Engine(spec, device="cpu", kernels=False)(images))


# --- the INT16 configuration and the float family ------------------------------

INT16 = "8,8,8,8,16,8,16,8"
# (spec families, kernel families) of the INT16 variants' three softmaxes
INT16_FAMILIES = {"ivit": (("ivit",) * 3, ("ivit",) * 3),
                  "ibert": (("ibert",) * 3, ("ibert",) * 3),
                  "ppoly": ((PPOLY_FAMILIES[0],) * 2 + ("ibert",), ("ppoly", "ppoly", "ibert"))}


def _int16_block(dev, fam, c=C, heads=HEADS, bits=INT16):
    gelu, softmax, ln = INT16_FAMILIES[fam][0]
    cfg = dataclasses.replace(
        deit_small_config(depth=1, img_size=64, ln=ln, gelu=gelu, softmax=softmax,
                          bitwidths=bits),
        embed_dim=c, num_heads=heads, num_classes=10)
    blk = synthetic_spec(cfg, seed=3).params["blocks"][0]
    return {k: torch.as_tensor(v).to(dev) for k, v in blk.items()}


def _attn_kw(b, mix, heads, n_valid, fast=True):
    kw = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
              qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
              m_attn=b["m_attn"], s_attn=b["s_attn"], s_exp_act=b.get("s_exp_act"),
              m_av=b["m_av"], proj_w=b["proj_w"], proj_b=b["proj_b"],
              m_proj=b["m_proj"], m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
              num_heads=heads, n_valid=n_valid, fast_exp=fast, fast_poly=fast,
              sm_base=mix[1], ln_base=mix[2])
    return kw | (_ppoly_sm_kw(b) if mix[1] == "ppoly" else {})


@pytest.mark.parametrize("fam", list(INT16_FAMILIES))
def test_cuda_attn_block_16bit_probs(cuda, fam):
    """``attn_block`` at ``sm_bit`` 16 with an int16 output: int8 and int16
    input, padding tokens, the LN in the kernel and hoisted, fast flags both
    ways, head dims 32 (C 64) and 128 (C 128, one head, 256 tokens)."""
    mix = INT16_FAMILIES[fam][1]
    for c, heads, np_, nv in ((C, HEADS, NP, NV), (128, 1, 256, 250)):
        b = _int16_block(cuda, fam, c, heads)
        for bits in (8, 16):
            x = _stream(cuda, (2, np_, c), bits, seed=c + bits)
            for fast in (False, True):
                kw = _attn_kw(b, mix, heads, nv, fast) | dict(sm_bit=16, out_bits=16)
                for ln_in in (None, kb._ln8(x, mix[2], kw["ln_bias"], kw["ln_shift"],
                                            kw["m_ln"], None)):
                    got = kb.attn_block(x, ln_in=ln_in, **kw)
                    torch.cuda.synchronize()
                    assert got.dtype == torch.int16
                    want = kb.attn_block_ref(x, ln_in=ln_in, **kw)
                    assert torch.equal(got[:, :nv], want[:, :nv]), (c, bits, fast)


@pytest.mark.parametrize("c,hidden", MLP_SHAPES, ids=[f"C{c}" for c, _ in MLP_SHAPES])
def test_cuda_mlp_block_int16_to_int8(cuda, c, hidden):
    """``mlp_block`` from int16 rows to int8 (and int8 rows to int16) in both
    MLP blocks (the 32-row one at hidden 3072 and 4096), the three GELUs,
    ragged rows, the LN in the kernel and hoisted."""
    for fam, (_, mix) in INT16_FAMILIES.items():
        b = _int16_block(cuda, fam, c, c // 32)
        assert tuple(b["fc1_w"].shape) == (c, hidden)
        extra = _ppoly_gelu_kw(b, True) if fam == "ppoly" else {}
        for r in (1, 65):
            for x_bits, out_bits in ((16, 8), (8, 16)):
                x = _stream(cuda, (r, c), x_bits, seed=r + x_bits)
                kw = _swin_mlp_kw(b, mix, True) | dict(out_bits=out_bits) | extra
                for ln_in in (None, kb._ln8(x, mix[2], kw["ln_bias"], kw["ln_shift"],
                                            kw["m_ln"], None)):
                    got = kb.mlp_block(x, ln_in=ln_in, **kw)
                    torch.cuda.synchronize()
                    assert got.dtype == (torch.int8 if out_bits == 8 else torch.int16)
                    want = kb.mlp_block_ref(x, ln_in=ln_in, **kw)
                    assert torch.equal(got, want), (fam, r, x_bits, ln_in is None)


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("fam", list(INT16_FAMILIES))
def test_cuda_attn_block_edges(cuda, fam, bits):
    """``chip_smoke.int16_edge_inputs``: a one-hot row (whose ibert
    probability rounds to 2**(bits - 1) and saturates), v at -128 and 127,
    flat rows, hot padding keys."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import int16_edge_inputs
    mix = INT16_FAMILIES[fam][1]
    b = _int16_block(cuda, fam)
    x, ln_in, over = int16_edge_inputs(torch, b, HEADS, B, NP, NV, cuda)
    kw = _attn_kw(b, mix, HEADS, NV) | dict(sm_bit=bits, out_bits=bits) | over
    got = kb.attn_block(x, ln_in=ln_in, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :NV], kb.attn_block_ref(x, ln_in=ln_in, **kw)[:, :NV])


def test_cuda_int16_and_float_engines(cuda):
    """INT16 ivit and ibert engines: 2 + 2 launches, logits equal to the
    plain engine on the card and the CPU.  A float-family engine launches
    no kernel, equals its unfused forward on the card, and is within
    ``tests/test_torch_port_float.py``'s bound of the CPU's logits."""
    images = np.random.default_rng(1).normal(size=(3, 64, 64, 3)).astype(np.float32)
    for fam in ("ivit", "ibert"):
        cfg = dataclasses.replace(_small_config(2, (fam,) * 3),
                                  bitwidths=BitWidths.from_spec(INT16))
        spec = synthetic_spec(cfg, seed=0)
        want = Engine(spec, kernels=False)(images)
        kb.mlp_block.launches = kb.attn_block.launches = 0
        got = Engine(spec)(images)
        torch.cuda.synchronize()
        assert (kb.mlp_block.launches, kb.attn_block.launches) == (2, 2)
        assert torch.equal(got, want)
        assert torch.equal(want.cpu(), Engine(spec, device="cpu", kernels=False)(images))
    spec = synthetic_spec(_small_config(2, ("float", "float", "ibert")), seed=0)
    kb.mlp_block.launches = kb.attn_block.launches = 0
    got = Engine(spec)(images)
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.attn_block.launches) == (0, 0)
    assert torch.equal(got, Engine(spec, kernels=False)(images))
    cpu = Engine(spec, device="cpu")(images)
    assert (got.cpu() - cpu).abs().max() <= 0.05 * cpu.abs().max()


def test_cuda_wrappers_refuse_what_no_kernel_runs(cuda):
    """Bits the kernels do not take and the float family raise; nothing
    falls back.  The integer-sqrt ibert LN, refused before the kernels took
    it, runs, equal to the plain versions."""
    mix = INT16_FAMILIES["ibert"][1]
    b, x = _int16_block(cuda, "ibert"), _x(cuda)
    kw = _attn_kw(b, mix, HEADS, NV)
    for bad in (dict(sm_bit=4), dict(sm_bit=12), dict(attn_bits=16), dict(out_bits=32)):
        with pytest.raises(ValueError, match="attn_block kernel"):
            kb.attn_block(x, **(kw | bad))
    got = kb.attn_block(x, use_int_sqrt=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :NV], kb.attn_block_ref(x, use_int_sqrt=True, **kw)[:, :NV])
    with pytest.raises(NotImplementedError, match="no fused block kernel"):
        kb.attn_block(x, **(kw | dict(sm_base="float")))
    x2 = _stream(cuda, (B * NP, C), 16, seed=2)
    kw = _swin_mlp_kw(b, mix, True)
    for bad in (dict(out_bits=32), dict(mlp_bits=24)):
        with pytest.raises(ValueError, match="mlp_block kernel"):
            kb.mlp_block(x2, **(kw | bad))
    got = kb.mlp_block(x2, use_int_sqrt=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, kb.mlp_block_ref(x2, use_int_sqrt=True, **kw))
    with pytest.raises(NotImplementedError, match="no fused block kernel"):
        kb.mlp_block(x2, **(kw | dict(gelu_base="float")))


# --- the table forms and the integer-sqrt LN ----------------------------------

# (spec families, kernel families) of the table forms
LUT_FAMILIES = {"ivit": (("ivit",) * 3, ("ivit",) * 3),
                "ibert": (("ibert",) * 3, ("ibert",) * 3),
                "ppoly": ((PPOLY_FAMILIES[0],) * 2 + ("ibert",), ("ppoly", "ppoly", "ibert"))}


@pytest.fixture
def lut_on(monkeypatch):
    monkeypatch.setenv("IVIT_LUT", "1")
    monkeypatch.setenv("IVIT_XLA_LUT", "1")


def _bump0(t):
    """A copy of a table with its first entry (the row max's exp for the
    softmax and ShiftGELU) halved, or raised by one where that is 0."""
    t = t.clone()
    t[0] = torch.floor(t[0] / 2) if t[0] > 1 else t[0] + 1
    return t


def _lut_pair(fn, ref, x, kw, tables, monkeypatch, ref_tables=None):
    """The kernel with the tables equal to its plain version (given
    ``ref_tables``, the tables the wrapper's gate lets through), with the
    switch on; the same call with the switch off, the towers."""
    got = fn(x, **kw, **tables)
    torch.cuda.synchronize()
    assert torch.equal(got, ref(x, **kw, **(tables if ref_tables is None else ref_tables)))
    monkeypatch.delenv("IVIT_LUT")
    towers = fn(x, **kw, **tables)
    monkeypatch.setenv("IVIT_LUT", "1")
    return got, towers


@pytest.mark.parametrize("fam", list(LUT_FAMILIES))
def test_cuda_lut_block_kernels_match_plain_versions(cuda, fam, lut_on, monkeypatch):
    """Both ViT kernels with a freeze's tables (``with_tables``), ``IVIT_LUT``
    set: equal to their plain versions, and to the towers; 8- and 16-bit
    probabilities (int16 out), both ivit row sums, the LN in the kernel and
    hoisted, and a changed table, which moves the ivit kernels off the
    towers."""
    from ivit_tpu_torch.engine.synthetic import with_tables
    spec_mix, mix = LUT_FAMILIES[fam]
    for bits in ("8", INT16):
        cfg = dataclasses.replace(_small_config(1, spec_mix), bitwidths=BitWidths.from_spec(bits))
        b = {k: torch.as_tensor(v).to(cuda)
             for k, v in with_tables(synthetic_spec(cfg, seed=3)).params["blocks"][0].items()}
        x = _x(cuda)
        sm_bit = cfg.bitwidths.softmax
        kw = _attn_kw(b, mix, HEADS, NV) | dict(sm_bit=sm_bit, out_bits=sm_bit)
        for sum_i32 in ((False, True) if fam == "ivit" else (False,)):
            for ln_in in (None, kb._ln8(x, mix[2], kw["ln_bias"], kw["ln_shift"], kw["m_ln"], None)):
                for lut in (b["sm_lut"], _bump0(b["sm_lut"])):
                    tables = dict(sm_lut=lut, sm_sum_i32=sum_i32)
                    got, towers = _lut_pair(kb.attn_block, kb.attn_block_ref, x,
                                            kw | dict(ln_in=ln_in), tables, monkeypatch)
                    same = torch.equal(got[:, :NV], towers[:, :NV])
                    assert same == (lut is b["sm_lut"]) or fam != "ivit", (bits, sum_i32)
        x2 = _stream(cuda, (B * NP, C), 16 if bits == INT16 else 8, seed=2)
        kw = _swin_mlp_kw(b, mix, True) | dict(out_bits=8)
        if fam == "ppoly":
            kw |= _ppoly_gelu_kw(b, True)
        for lut in (b["gelu_lut"], _bump0(b["gelu_lut"])):
            got, towers = _lut_pair(kb.mlp_block, kb.mlp_block_ref, x2, kw,
                                    dict(gelu_lut=lut), monkeypatch)
            assert torch.equal(got, towers) == (lut is b["gelu_lut"]) or fam != "ivit"


@pytest.mark.parametrize("fam", list(LUT_FAMILIES))
def test_cuda_lut_swin_kernels_match_plain_versions(cuda, fam, lut_on, monkeypatch):
    """Both Swin kernels with a freeze's tables, C 96 and 192: the shifted
    block takes ``sm_sat`` where its mask is negative (ivit, ibert; a ppoly
    shifted block keeps the towers, as JAX's gate says); equal to the plain
    versions and to the towers, and with ``sm_sat`` changed, off them."""
    from ivit_tpu_torch.engine.synthetic import with_tables
    spec_mix, mix = LUT_FAMILIES[fam]
    spec = with_tables(_swin_spec(spec_mix))
    assert spec.config.use_lut
    for i, (b, heads, nw, shift) in enumerate(_swin_blocks(spec, cuda)):
        c = b["ln1_bias_int"].shape[0]
        x = _stream(cuda, (2 * nw, 49, c), 16, seed=i)
        kw = _swin_attn_kw(b, mix, True, heads, nw, shift)
        if fam == "ppoly":
            kw |= _ppoly_sm_kw(b)
        assert ("sm_sat" in b) == (shift > 0 and fam != "ppoly")
        sats = [b.get("sm_sat")] + ([b["sm_lut"][:1].reshape(())] if "sm_sat" in b else [])
        for sat in sats:
            tables = dict(sm_lut=b["sm_lut"], sm_sum_i32=spec.config.sm_sum_i32, sm_sat=sat)
            gated = tables if sat is not None or not shift else {}   # block.py:1486
            got, towers = _lut_pair(kb.swin_attn_block, kb.swin_attn_block_ref, x,
                                    kw, tables, monkeypatch, gated)
            assert torch.equal(got, towers) == (sat is b.get("sm_sat")), (i, fam)
        x2 = _stream(cuda, (2 * nw * 49, c), 16, seed=10 + i)
        kw = _swin_mlp_kw(b, mix, True) | (_ppoly_gelu_kw(b, True) if fam == "ppoly" else {})
        got, towers = _lut_pair(kb.mlp_block, kb.mlp_block_ref, x2, kw,
                                dict(gelu_lut=b["gelu_lut"]), monkeypatch)
        assert torch.equal(got, towers)


@pytest.mark.parametrize("heads", EDGE_HEADS, ids=[f"dh{128 // h}" for h in EDGE_HEADS])
def test_cuda_lut_attention_edge_shapes(cuda, heads, lut_on, monkeypatch):
    """The ivit and ibert table-form cores at the attention tiles' edges, C
    128 with head dims 32, 64 and 128: ViT token counts 1 to 256 with
    padding tokens, both ivit row sums; Swin windows of 49 and 64 tokens,
    the shifted block with ``sm_sat``; equal to the plain versions and to
    the towers."""
    from ivit_tpu_torch.engine.synthetic import with_tables
    for family in ("ivit", "ibert"):
        cfg = dataclasses.replace(
            deit_small_config(depth=1, img_size=64, ln=family, gelu=family,
                              softmax=family),
            embed_dim=128, num_heads=heads, num_classes=10)
        b = {k: torch.as_tensor(v).to(cuda) for k, v in
             with_tables(synthetic_spec(cfg, seed=5)).params["blocks"][0].items()}
        for i, (np_, nv) in enumerate(EDGE_TOKENS):
            x = _stream(cuda, (2, np_, 128), 8, seed=30 + i)
            kw = _attn_kw(b, (family,) * 3, heads, nv) | dict(x=x)
            for sum_i32 in (False, True):
                tables = dict(sm_lut=b["sm_lut"], sm_sum_i32=sum_i32)
                got = kb.attn_block(**kw, **tables)
                torch.cuda.synchronize()
                want = kb.attn_block_ref(**kw, **tables)
                assert torch.equal(got[:, :nv], want[:, :nv]), (family, np_, sum_i32)
                monkeypatch.delenv("IVIT_LUT")
                assert torch.equal(got[:, :nv], kb.attn_block(**kw, **tables)[:, :nv])
                monkeypatch.setenv("IVIT_LUT", "1")
        for window in (7, 8):
            spec = with_tables(synthetic_swin_spec(swin_tiny_config(
                depths=(2,), img_size=8 * window, embed_dim=128, stage_heads=(heads,),
                window_size=window, num_classes=10, gelu=family, softmax=family,
                ln=family), seed=5))
            grid = 16 if window == 8 else 14
            for i, (blk, h, nw, shift) in enumerate(_swin_blocks(spec, cuda, grid)):
                x = _stream(cuda, (2 * nw, window * window, 128), 16, seed=40 + i)
                kw = _swin_attn_kw(blk, (family,) * 3, True, h, nw, shift)
                tables = dict(sm_lut=blk["sm_lut"], sm_sum_i32=spec.config.sm_sum_i32,
                              sm_sat=blk.get("sm_sat"))
                gated = tables if "sm_sat" in blk or not shift else {}
                got, towers = _lut_pair(kb.swin_attn_block, kb.swin_attn_block_ref, x,
                                        kw, tables, monkeypatch, gated)
                assert torch.equal(got, towers), (family, window, shift)


def test_cuda_lut_engines_match_plain_engines(cuda, lut_on, monkeypatch):
    """ViT (ivit, ibert) and Swin (ivit) specs with their tables: ``Engine``
    on the kernels with ``IVIT_LUT`` set equals the plain engine with the
    tables (``IVIT_XLA_LUT``) on the card and the CPU, and the engines with
    the switches off."""
    from ivit_tpu_torch.engine.synthetic import with_tables
    vit_img = np.random.default_rng(1).normal(size=(3, 64, 64, 3)).astype(np.float32)
    swin_img = np.random.default_rng(2).normal(size=(2, 56, 56, 3)).astype(np.float32)
    for spec, images in ((with_tables(synthetic_spec(_small_config(2, ("ivit",) * 3), seed=0)), vit_img),
                         (with_tables(synthetic_spec(_small_config(2), seed=0)), vit_img),
                         (with_tables(_swin_spec(("ivit",) * 3)), swin_img)):
        got = Engine(spec)(images)
        assert torch.equal(got, Engine(spec, kernels=False)(images))
        assert torch.equal(got.cpu(), Engine(spec, device="cpu", kernels=False)(images))
        assert torch.equal(got.cpu(), Engine(spec, device="cpu")(images))
        monkeypatch.delenv("IVIT_LUT")
        assert torch.equal(got, Engine(spec)(images))
        monkeypatch.setenv("IVIT_LUT", "1")


def _var_rows(dev, c, dtype=torch.int8):
    """Rows of ``c`` channels whose ibert LN at shift 0 has the variances
    3, 15, 63, 80 and 99, where I-BERT's integer sqrt and floor(sqrt)
    differ (``tests/test_torch_port_lut.py``), then seeded random rows."""
    rows = np.zeros((8, c), np.int64)
    rows[0, :3] = 1
    rows[1, :15] = 1
    rows[2, :63] = np.resize([1, -1], 63)
    rows[3, :20] = np.resize([2, -2], 20)
    rows[4, :9] = np.resize([3, -3], 9)
    rows[4, 9:27] = np.resize([1, -1], 18)
    lim = 127 if dtype == torch.int8 else 2**14
    rows[5:] = np.random.default_rng(0).integers(-lim, lim, (3, c))
    return torch.from_numpy(rows).to(dtype).to(dev)


def test_cuda_int_sqrt_ln_matches_plain_versions(cuda):
    """The three kernels with the integer-sqrt ibert LN (shift 0, the LN
    multipliers an eighth of the spec's so these rows' outputs stay in int8)
    equal their plain versions, on rows where the two roots differ, and the
    plain versions run the same root on the card as on the CPU."""
    from ivit_tpu_torch.ops import ibert as tib
    n = torch.cat([2.0 ** torch.arange(1, 34).repeat_interleave(80)
                   - torch.arange(-16, 64).repeat(33), torch.arange(1, 5000)]).float()
    assert torch.equal(tib.int_bitlength_sqrt(n.to(cuda)).cpu(), tib.int_bitlength_sqrt(n))
    b = _block(cuda)
    b |= dict(ln1_shift=torch.zeros((), device=cuda), ln2_shift=torch.zeros((), device=cuda),
              m_ln1=b["m_ln1"] / 8, m_ln2=b["m_ln2"] / 8)
    x = _var_rows(cuda, C)
    ln = (b["ln2_bias_int"], b["ln2_shift"], b["m_ln2"], None)
    assert (kb._ln8(x, "ibert", *ln, use_int_sqrt=True)
            != kb._ln8(x, "ibert", *ln))[:5].any(-1).all()
    mlp = _swin_mlp_kw(b, ("ibert",) * 3, True) | dict(out_bits=8)
    got = kb.mlp_block(x, use_int_sqrt=True, **mlp)
    torch.cuda.synchronize()
    assert torch.equal(got, kb.mlp_block_ref(x, use_int_sqrt=True, **mlp))
    xa = torch.cat([x, x.flip(0), x[:1]])[None].repeat(2, 1, 1)   # 17 tokens
    attn = _attn_kw(b, ("ibert",) * 3, HEADS, 17)
    got = kb.attn_block(xa, use_int_sqrt=True, **attn)
    torch.cuda.synchronize()
    assert torch.equal(got, kb.attn_block_ref(xa, use_int_sqrt=True, **attn))
    # Swin: int16 windows of 49 tokens at C 96
    sb, heads, nw, _ = _swin_blocks(_swin_spec(("ibert",) * 3), cuda)[0]
    sb |= dict(ln1_shift=torch.zeros((), device=cuda), m_ln1=sb["m_ln1"] / 8)
    xw = _var_rows(cuda, 96, torch.int16).repeat(7, 1)[:49][None].repeat(2 * nw, 1, 1)
    kw = _swin_attn_kw(sb, ("ibert",) * 3, True, heads, nw, 0)
    got = kb.swin_attn_block(xw, use_int_sqrt=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, kb.swin_attn_block_ref(xw, use_int_sqrt=True, **kw))


# --- the LayerNorm + requant outside the block kernels --------------------------

# (C, stream, rows, ibert shift): DeiT-S's head (the cls rows of a [64, 197,
# 384] stream, read in place), Swin-T's patch norm (96 int8), its merges
# (384, 768, 1,536 int16) and final norm (768 int16) at ragged row counts
LN_SITES = [(384, torch.int8, "cls", 0), (96, torch.int8, 1000, 0),
            (384, torch.int16, 777, 2), (768, torch.int16, 300, 2),
            (1536, torch.int16, 70, 5), (768, torch.int16, 129, 2)]
LN_FAMS = [("ivit", False), ("ibert", False), ("ibert", True)]


def _ln_rows(dev, c, dtype, n, seed):
    """Seeded rows, then the stream's extremes (both ends, the two ends
    alternating, a flat row, a spike)."""
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(seed)
    rows = np.clip(np.round(rng.normal(0, 40 if dtype == torch.int8 else 6000, (n, c))),
                   info.min, info.max)
    edge = np.zeros((5, c))
    edge[0], edge[1] = info.min, info.max
    edge[2] = np.resize([info.min, info.max], c)
    edge[3] = 17
    edge[4, c // 3] = info.max
    return torch.from_numpy(np.concatenate([rows, edge])).to(dtype).to(dev)


def _ln_leaves(dev, c, shift, seed):
    """Bias, multiplier and shift at a freeze's scale (the LN's integers
    are z * 2**30 / sqrt(C) for a standard score z)."""
    rng = np.random.default_rng(seed)
    unit = 2.0**30 / np.sqrt(c)
    bias = torch.from_numpy(np.floor(rng.normal(0, unit / 2, c))).float().to(dev)
    m = torch.from_numpy(rng.uniform(20, 120, c) / unit).float().to(dev)
    return bias, m, torch.tensor(float(shift), device=dev)


@pytest.mark.parametrize("site", LN_SITES, ids=[f"C{s[0]}-{str(s[1])[6:]}-{s[2]}"
                                                for s in LN_SITES])
@pytest.mark.parametrize("fam,isqrt", LN_FAMS, ids=["ivit", "ibert", "ibert_isqrt"])
def test_cuda_ln_requant_matches_plain_version(cuda, fam, isqrt, site):
    """The LN + requant kernel equals its plain version (the engines' chain)
    bit for bit at the engines' widths and streams, both families and the
    integer-sqrt ibert LN, on rows at the stream's extremes; a flat ibert
    row's NaN is pinned to 0; one launch a call."""
    c, dtype, n, shift = site
    bias, m, sh = _ln_leaves(cuda, c, shift, seed=c)
    if n == "cls":
        x = _ln_rows(cuda, c, dtype, 59, seed=5)[:, None].repeat(1, 197, 1)
        x[:, 1:] = _ln_rows(cuda, c, dtype, 59, seed=6)[:, None]
        x = x[:, :1]
        assert not x.is_contiguous()
    else:
        x = _ln_rows(cuda, c, dtype, n, seed=c + n)
    kw = dict(ln_base=fam, use_int_sqrt=isqrt)
    before = knl.ln_requant.launches
    got = knl.ln_requant(x, bias, m, sh, **kw)
    torch.cuda.synchronize()
    assert knl.ln_requant.launches == before + 1
    want = knl.ln_requant_ref(x, bias, m, sh, **kw)
    assert got.shape == x.shape and got.dtype == torch.int8
    assert torch.equal(got, want)
    flat = got.reshape(-1, c)[-2]
    assert (flat == 0).all() if fam == "ibert" else flat.ne(0).any()
    assert got.min() == -128 and got.max() == 127


@pytest.mark.parametrize("c,dtype,offset", [(100, torch.int8, 0), (2064, torch.int16, 0),
                                             (96, torch.int8, 1), (384, torch.int16, 2)])
def test_cuda_ln_requant_refuses_rows_off_its_chunks(cuda, c, dtype, offset):
    """The kernel reads and writes rows in whole 16-byte chunks: a width
    that is not a multiple of 16 or past Swin-B's 2,048, or a row off a
    16-byte boundary, raises, and nothing is launched."""
    bias, m, sh = _ln_leaves(cuda, c, 0, seed=c)
    x = _at_byte_offset(_ln_rows(cuda, c, dtype, 9, seed=c), offset)
    before = knl.ln_requant.launches
    with pytest.raises(ValueError, match="16"):
        knl.ln_requant(x, bias, m, sh, ln_base="ivit")
    assert knl.ln_requant.launches == before


def test_cuda_ln_requant_launches_and_waits(cuda):
    """One ``ln_requant`` launch a norm outside the blocks: 5 a fused Swin-T
    forward (patch norm, three merges, final norm), 1 a fused DeiT-S one,
    none on the plain engine, logits equal to the plain engine's; under the
    profiler a DeiT-S forward waits for the card nowhere (no ``ivit.sync``),
    a Swin-T one once, in the pool of ``ivit.head``."""
    from torch.profiler import ProfilerActivity, profile

    from ivit_tpu_torch.utils import spans
    rng = np.random.default_rng(3)
    for spec, n, syncs in ((synthetic_swin_spec(swin_tiny_config(), seed=0), 5, 1),
                           (synthetic_spec(deit_small_config(), seed=0), 1, 0)):
        x = torch.from_numpy(rng.normal(size=(4, 224, 224, 3)).astype(np.float32)).to(cuda)
        want = Engine(spec, kernels=False)(x)
        knl.ln_requant.launches = 0
        Engine(spec, kernels=False)(x)
        assert knl.ln_requant.launches == 0
        eng = Engine(spec)
        got = eng(x)
        torch.cuda.synchronize()
        assert knl.ln_requant.launches == n
        assert torch.equal(got, want)
        spans.clear()
        with profile(activities=[ProfilerActivity.CUDA]):
            eng(x).cpu()
        recs = spans.spans()
        waits = [r for r in recs if r.name == "ivit.sync"]
        assert len(waits) == syncs
        assert all(recs[r.parent].name == "ivit.head" for r in waits)
        assert sum(r.name == "ivit.kernel.ln_requant" for r in recs) == n
        spans.clear()


# --- the QAT sim and its freeze on the card ------------------------------------

QAT_MIXES = [("ivit", "ivit", "ivit", "8"), ("ibert", "ibert", "ibert", "8"),
             ("ivit", "ivit", "ivit", "8,8,8,8,16,8,16,8")]


def _qat_sim(dev, gelu, softmax, ln, bits):
    from ivit_tpu_torch.models import VisionTransformer
    return VisionTransformer(img_size=64, patch_size=16, embed_dim=C, depth=2,
                             num_heads=HEADS, num_classes=10, gelu_type=gelu,
                             softmax_type=softmax, layernorm_type=ln,
                             bitwidths=bits, device=dev, seed=0)


@pytest.mark.parametrize("mix", QAT_MIXES, ids=["/".join(m[:3]) + "@" + m[3] for m in QAT_MIXES])
def test_cuda_qat_sim_calibrates_and_freezes_as_cpu(cuda, mix):
    """At 64 px: the sim calibrated on the card gives the CPU's ranges, its
    freeze the CPU's spec, its frozen forward the CPU's logits, and
    ``Engine(spec)`` on the block kernels the sim's logits (the INT16
    configuration within JAX's bound, tests/test_engine.py:144)."""
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn((4, 64, 64, 3), generator=gen) for _ in range(3)]
    card, cpu = _qat_sim(cuda, *mix), _qat_sim("cpu", *mix)
    with torch.no_grad():
        for x in xs[:2]:
            assert torch.equal(card(x.to(cuda), running_stat=True).cpu(),
                               cpu(x, running_stat=True))
        assert differing_leaves(variables_to_numpy(card), variables_to_numpy(cpu)) == []
        spec, cpu_spec = freeze_model(card), freeze_model(cpu)
        assert differing_leaves(spec.params, cpu_spec.params) == []
        assert spec.config == cpu_spec.config
        sim = card(xs[2].to(cuda))
        assert torch.equal(sim.cpu(), cpu(xs[2]))
    kb.mlp_block.launches = kb.attn_block.launches = 0
    got = Engine(spec)(xs[2].to(cuda))
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.attn_block.launches) == (2, 2)
    if mix[3] == "8":
        assert torch.equal(got, sim)
    else:
        assert (got - sim).abs().max() < 1e-5 * sim.abs().max() + 1e-6


SWIN_QAT_GEOM = dict(img_size=56, patch_size=4, embed_dim=96, depths=(2, 2),
                     num_heads=(3, 6), window_size=7, num_classes=10,
                     drop_path_rate=0.0)


def _swin_qat_sim(dev, fam):
    from ivit_tpu_torch.models import SwinTransformer
    return SwinTransformer(gelu_type=fam, softmax_type=fam, layernorm_type=fam,
                           device=dev, seed=0, **SWIN_QAT_GEOM)


@pytest.mark.parametrize("fam", ["ivit", "ibert"])
def test_cuda_swin_qat_sim_calibrates_and_freezes_as_cpu(cuda, fam):
    """At 56 px, Swin-T's widths (C 96 and 192; a shifted stage, a clamped
    one): the card's ranges, spec and frozen logits equal the CPU's, and
    ``Engine(spec)`` on ``swin_attn_block`` / ``mlp_block`` (4 + 4
    launches) gives the sim's logits."""
    from ivit_tpu_torch.engine.swin_int import freeze_swin_model
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn((4, 56, 56, 3), generator=gen) for _ in range(3)]
    card, cpu = _swin_qat_sim(cuda, fam), _swin_qat_sim("cpu", fam)
    with torch.no_grad():
        for x in xs[:2]:
            assert torch.equal(card(x.to(cuda), running_stat=True).cpu(),
                               cpu(x, running_stat=True))
        assert differing_leaves(variables_to_numpy(card), variables_to_numpy(cpu)) == []
        spec, cpu_spec = freeze_swin_model(card), freeze_swin_model(cpu)
        assert differing_leaves(spec.params, cpu_spec.params) == []
        assert spec.config == cpu_spec.config
        sim = card(xs[2].to(cuda))
        assert torch.equal(sim.cpu(), cpu(xs[2]))
    kb.mlp_block.launches = kb.swin_attn_block.launches = 0
    got = Engine(spec)(xs[2].to(cuda))
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.swin_attn_block.launches) == (4, 4)
    assert torch.equal(got, sim)
    assert torch.equal(Engine(spec, kernels=False)(xs[2].to(cuda)), sim)


def test_cuda_serving_matches_engine(cuda):
    """ServingEngine on the card (pinned ring, events, the caller's
    stream): every answer equal to ``Engine(spec)``'s on the same images,
    for a ViT and a Swin spec, with a padded last batch."""
    from ivit_tpu_torch.engine.serving import ServingEngine
    specs = [(synthetic_spec(_small_config(2), seed=0), 64),
             (synthetic_swin_spec(swin_tiny_config(depths=(2, 2), img_size=56), seed=0), 56)]
    gen = torch.Generator().manual_seed(1)
    for spec, size in specs:
        images = torch.randn((11, size, size, 3), generator=gen)
        want = Engine(spec)(images.to(cuda)).cpu().numpy()
        with ServingEngine(spec, batch_size=4, max_wait_ms=20, inflight=2) as srv:
            got = srv.infer(images.numpy())
            m = srv.metrics.summary()
        np.testing.assert_array_equal(got, want)
        assert m["images"] == 11 and m["batches"] >= 3


def _train_sims(dev, kind):
    from ivit_tpu_torch.models import SwinTransformer, VisionTransformer
    if kind == "vit":
        return _qat_sim(dev, "ivit", "ivit", "ivit", "8"), 64
    # drop-path on: its masks come from a CPU generator on either device
    return SwinTransformer(gelu_type="ibert", softmax_type="ibert",
                           layernorm_type="ibert", device=dev, seed=0,
                           **dict(SWIN_QAT_GEOM, drop_path_rate=0.1)), 56


def _train_cfg(**kw):
    from ivit_tpu_torch.train.trainer import TrainConfig
    return TrainConfig(**{**dict(lr=1e-3, weight_decay=0.05, clip_grad=1.0, epochs=1,
                                 num_classes=10, batch_size=4), **kw})


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_cuda_train_step_matches_cpu(cuda, kind):
    """One train step (calibrated sim, clip, masked AdamW) on the card and on
    the CPU from the same state and batch: quant_stats equal leaf for leaf,
    gradients within 1e-4 of each tensor's largest (the backward's f32 sums
    run in other orders, TF32 off), params within 2 * lr (Adam normalises a
    near-zero gradient whose sign differs)."""
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    from ivit_tpu_torch.train.steps import (init_train_state, make_calibration_step,
                                            make_train_step)
    from ivit_tpu_torch.train.trainer import build_optimizer
    gen = torch.Generator().manual_seed(0)
    (card, size), (cpu, _) = _train_sims(cuda, kind), _train_sims("cpu", kind)
    xs = torch.randn((4, size, size, 3), generator=gen)
    batch = {"image": torch.randn((4, size, size, 3), generator=gen),
             "label": torch.tensor([1, 2, 3, 4])}
    out = []
    for model in (card, cpu):
        make_calibration_step(model)(xs)
        tx = build_optimizer(_train_cfg(), 4)[0]
        state, met = make_train_step(model, tx, 10)(
            init_train_state(model, tx), batch, torch.Generator().manual_seed(1))
        out.append((variables_to_numpy(model), float(met["loss"]),
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None}))
    (cv, closs, cg), (pv, ploss, pg) = out
    assert differing_leaves(cv["quant_stats"], pv["quant_stats"]) == []
    assert abs(closs - ploss) <= 1e-5 * abs(ploss)
    assert cg.keys() == pg.keys()
    for n, g in pg.items():
        assert (cg[n] - g).abs().max() <= 1e-4 * g.abs().max(), n
    for path in differing_leaves(cv["params"], pv["params"]):
        a, b = cv["params"], pv["params"]
        for k in path.strip("/").split("/"):
            a, b = a[k], b[k]
        assert np.abs(a - b).max() <= 2 * 1e-3 * (1 + 1e-6), path


@pytest.mark.parametrize("accum", [1, 2])
def test_cuda_optimizer_matches_cpu(cuda, accum):
    """The optimizer on the same gradients on the card and on the CPU, three
    updates: without clipping (AdamW with the mask; MultiSteps 2) the
    states and params bitwise equal (every step its own rounded f32
    operation, the roots ``sqrt_rn``, the scalars from the host); with
    clipping the global norm's sums run in other orders: states within 8
    ulps of each leaf's largest, params within two ulps plus 8 ulps of lr
    times a unit step (``tests/test_torch_port_train.py``'s bounds)."""
    from ivit_tpu_torch.train import optim
    from ivit_tpu_torch.train.trainer import build_optimizer
    rng = np.random.default_rng(0)
    params = {"blocks_0": {"fc1": {"kernel": rng.normal(size=(64, 32)),
                                   "bias": rng.normal(size=32)},
                           "fc2": {"kernel": rng.normal(size=(256, 512))}},
              "cls_token": rng.normal(size=(1, 1, 32)),
              "head": {"kernel": rng.normal(size=(32, 10))}}
    params = optim.tree_map(lambda a: a.astype(np.float32), params)
    grads = [optim.tree_map(lambda p: (rng.normal(size=p.shape) * s).astype(np.float32),
                            params) for s in (3.0, 0.01, 2.0, 1e-6, 1.0, 0.5)]
    for clip in (None, 1.0):
        out = []
        for dev in (cuda, torch.device("cpu")):
            tx = build_optimizer(_train_cfg(clip_grad=clip, eff_batch_size=4 * accum,
                                            epochs=2, warmup_epochs=1, warmup_lr=1e-5),
                                 3)[0]
            p = optim.tree_map(lambda a: torch.tensor(a, device=dev), params)
            st = tx.init(p)
            for g in grads[:3 * accum]:
                u, st = tx.update(optim.tree_map(lambda a: torch.tensor(a, device=dev), g),
                                  st, p)
                with torch.no_grad():
                    optim.apply_updates(p, u)
            out.append(optim.tree_map(lambda t: t.cpu().numpy(), {"s": st, "p": p}))
        (card, cpu) = out
        for path, want in optim.tree_paths(cpu):
            got = card
            for k in path:
                got = got[k]
            if clip is None or want.dtype != np.float32:
                np.testing.assert_array_equal(got, want, err_msg="/".join(path))
            elif path[0] == "p":
                bound = 2 * np.spacing(np.abs(want)) + 8 * np.float32(1e-3) * 2.0**-23
                assert (np.abs(got - want) <= bound).all(), path
            else:
                bound = 8 * np.spacing(np.float32(np.abs(want).max()))
                assert np.abs(got - want).max() <= bound, path


def test_cuda_checkpoint_round_trip(cuda, tmp_path):
    """A trained state saved from the card: the same bytes as its CPU copy
    saves, read back into a card sim and a CPU sim with equal logits."""
    from ivit_tpu_torch.models.convert import differing_leaves
    from ivit_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint, state_dict
    from ivit_tpu_torch.train.steps import (init_train_state, make_calibration_step,
                                            make_train_step)
    from ivit_tpu_torch.train.trainer import build_optimizer, init_ema, update_ema
    gen = torch.Generator().manual_seed(2)
    sim, _ = _train_sims(cuda, "vit")
    make_calibration_step(sim)(torch.randn((4, 64, 64, 3), generator=gen))
    tx = build_optimizer(_train_cfg(eff_batch_size=8), 4)[0]
    state = init_train_state(sim, tx)
    ema = init_ema(state["params"])
    step = make_train_step(sim, tx, 10)
    for _ in range(3):
        state, _ = step(state, {"image": torch.randn((4, 64, 64, 3), generator=gen),
                                "label": torch.tensor([0, 1, 2, 3])})
        update_ema(ema, state["params"], 0.9)
    save_checkpoint(str(tmp_path / "card"), state, epoch=0, best_acc1=0.0,
                    model_config={}, ema_params=ema)
    cpu_state = {k: v for k, v in state_dict(state).items()}
    from ivit_tpu_torch.train.optim import tree_map
    host = tree_map(lambda a: torch.from_numpy(a.copy()), cpu_state)
    save_checkpoint(str(tmp_path / "cpu"), host, epoch=0, best_acc1=0.0,
                    model_config={}, ema_params=tree_map(lambda t: t.cpu(), ema))
    for name in ("state.msgpack", "meta.json"):
        assert (tmp_path / "card" / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes()
    x = torch.randn((4, 64, 64, 3), generator=gen)
    with torch.no_grad():
        want = sim(x.to(cuda))
    for dev in (cuda, torch.device("cpu")):
        fresh, _ = _train_sims(dev, "vit")
        fresh.cls_token.data.zero_()
        loaded, _ = load_checkpoint(str(tmp_path / "card"),
                                    init_train_state(fresh, build_optimizer(
                                        _train_cfg(eff_batch_size=8), 4)[0]))
        assert differing_leaves(state_dict(loaded), state_dict(state, ema)) == []
        with torch.no_grad():
            assert torch.equal(fresh(x.to(dev)).cpu(), want.cpu())


def test_cuda_sqrt_rn_matches_cpu(cuda):
    """The LayerNorm's ``sqrt_rn`` on the card is the correctly rounded f32
    root (numpy's, the CPU's; ``tests/test_torch_port_ops.py``), where
    torch's CUDA f32 ``sqrt`` is an ulp off for some variances
    (1,200,810,240: a Swin-T ibert block's)."""
    from ivit_tpu_torch.ops.quant import sqrt_rn
    gen = torch.Generator().manual_seed(0)
    v = torch.cat([torch.randint(0, 2**32, (1 << 20,), generator=gen,
                                 dtype=torch.int64).float(),
                   torch.tensor([0.0, 1200810240.0])])
    got = sqrt_rn(v.to(cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(), np.sqrt(v.numpy()))
    assert torch.equal(got, sqrt_rn(v))


def _trainer_folder(root, rng, n, side=(48, 96)):
    """An ImageFolder of ``n`` PNG images a class in 2 classes (the writer
    of ``chip_smoke.py``'s trainer phase)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    for c in range(2):
        os.makedirs(root / f"c{c}")
        for k in range(n):
            h, w = (int(v) for v in rng.integers(side[0], side[1], 2))
            chip_smoke.write_png(str(root / f"c{c}" / f"{k}.png"),
                                 rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_cuda_trainer_matches_cpu_calibration(cuda, tmp_path, monkeypatch):
    """``Trainer`` on the card over an ImageFolder (a depth-2 64 px ViT, the
    reference's augmentation, Mixup, the EMA): its calibration equal to a
    CPU Trainer's leaf for leaf, then one epoch with finite losses, its
    checkpoint resumed at epoch 1 with the same state."""
    from ivit_tpu_torch.models import VisionTransformer
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    from ivit_tpu_torch.train import trainer as ttrainer
    from ivit_tpu_torch.train.checkpoint import state_dict
    from ivit_tpu_torch.train.data import ImageFolderDataset
    monkeypatch.setattr(ttrainer, "str2model", lambda name: lambda **kw: VisionTransformer(
        patch_size=16, embed_dim=64, depth=2, num_heads=2, **kw))
    rng = np.random.default_rng(0)
    _trainer_folder(tmp_path / "train", rng, 8)
    _trainer_folder(tmp_path / "val", rng, 2)
    ds, val = (ImageFolderDataset(str(tmp_path / s)) for s in ("train", "val"))
    cfg = _train_cfg(img_size=64, num_classes=2, calibration_batches=2, model_ema=True,
                     output_dir=str(tmp_path / "runs"), run_id="t", log_interval=1)
    card, cpu = (ttrainer.Trainer(cfg, ds, val, device=d) for d in (cuda, "cpu"))
    card.calibrate()
    cpu.calibrate()
    assert differing_leaves(variables_to_numpy(card.model)["quant_stats"],
                            variables_to_numpy(cpu.model)["quant_stats"]) == []
    card.fit()
    assert card.start_epoch == 0 and int(card.state["step"]) == 4
    resumed = ttrainer.Trainer(dataclasses.replace(
        cfg, epochs=2, resume=str(tmp_path / "runs" / "checkpoint_t")), ds, val, device=cuda)
    assert resumed.start_epoch == 1
    assert differing_leaves(state_dict(card.state, card.ema_params),
                            state_dict(resumed.state, resumed.ema_params)) == []
    resumed.fit()
    assert int(resumed.state["step"]) == 8


def test_cuda_native_preprocess_builds_from_source(cuda):
    """The card machine compiles ``native/preproc.cpp`` itself: the eval
    batch of the native path has the shape asked for, is finite and does
    not depend on the thread count.  (It is not Pillow's resize: it keeps
    f32 between its passes and does not clamp the bicubic overshoot, so it
    is held against JAX's binding of the same library on the CPU,
    ``tests/test_torch_port_data.py::test_native_binding_matches_jax``.)"""
    import os
    from ivit_tpu_torch.utils import native
    path = native.build()
    assert os.path.exists(path) and native.available()
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8)
            for h, w in rng.integers(40, 300, (5, 2))]
    got = native.preprocess_batch(imgs, out_size=64, num_threads=1)
    assert got.shape == (5, 64, 64, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(native.preprocess_batch(imgs, out_size=64,
                                                          num_threads=4), got)


# --- checkpoint interop, the envelope audit and the inference CLI -----------

def _cal_vit(dev, fam="ibert", seed=0):
    from ivit_tpu_torch.models import VisionTransformer
    sim = VisionTransformer(img_size=64, patch_size=16, embed_dim=64, depth=2,
                            num_heads=2, num_classes=10, gelu_type=fam, softmax_type=fam,
                            layernorm_type=fam, device=dev, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _ in range(2):
            sim(torch.randn((4, 64, 64, 3), generator=gen).to(dev), running_stat=True)
    return sim


def test_cuda_reference_checkpoint_round_trip(cuda, tmp_path):
    """A calibrated ViT and Swin sim on the card written as reference
    checkpoints and loaded into fresh sims there: every leaf equal, none
    missing, the reloaded engine's logits on the block kernels the
    original sim's."""
    from ivit_tpu_torch.compat.export_torch import save_reference_checkpoint
    from ivit_tpu_torch.compat.torch_ckpt import load_into_model
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.engine.swin_int import freeze_swin_model
    from ivit_tpu_torch.models import SwinTransformer
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    gen = torch.Generator().manual_seed(3)
    swin_kw = dict(gelu_type="ivit", softmax_type="ivit", layernorm_type="ivit",
                   **SWIN_QAT_GEOM)
    cases = [(_cal_vit(cuda), _cal_vit(cuda, seed=1), freeze_model, 64),
             (_swin_qat_sim(cuda, "ivit"), SwinTransformer(device=cuda, seed=1, **swin_kw),
              freeze_swin_model, 56)]
    with torch.no_grad():
        for _ in range(2):
            cases[1][0](torch.randn((4, 56, 56, 3), generator=gen).to(cuda),
                        running_stat=True)
    for sim, fresh, freeze, img in cases:
        path = str(tmp_path / "ckpt.pth.tar")
        save_reference_checkpoint(variables_to_numpy(sim), {}, path)
        _, report = load_into_model(fresh, path)
        assert report["missing"] == []
        assert differing_leaves(variables_to_numpy(fresh), variables_to_numpy(sim)) == []
        x = torch.randn((4, img, img, 3), generator=gen).to(cuda)
        with torch.no_grad():
            assert torch.equal(Engine(freeze(fresh))(x), sim(x))


def test_cuda_audit_matches_cpu(cuda):
    """The plain engine's envelope-audit records on the card equal the
    CPU's (the extrema and saturation shares read from device tensors);
    no hard violation; the kernel path taps only the sites outside the
    blocks."""
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.engine.vit_int import (audit_capture, audit_violations,
                                               engine_forward)
    spec = freeze_model(_cal_vit(cuda))
    x = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(4))

    def records(dev, kernels=False):
        with audit_capture() as recs:
            engine_forward(spec, x, kernels=kernels, device=dev)
        return [{k: float(v) if isinstance(v, torch.Tensor) else v for k, v in r.items()}
                for r in recs]
    card = records(cuda)
    assert card == records("cpu")
    assert len(card) == 2 + 2 * 18 + 2       # patch, 18 sites a block (ibert), LN + head
    assert audit_violations([r for r in card if "sat_frac" not in r]) == []
    fused = records(cuda, kernels=True)
    assert 0 < len(fused) < 10


def test_cuda_inference_cli_matches_cpu(cuda, tmp_path, monkeypatch):
    """The inference CLI on a reference checkpoint at 64 px (depth 2): on
    the card and on the CPU, the same counts and the same artifact (bytes,
    the clock frozen); the card run on the block kernels."""
    import time
    import ivit_tpu_torch.models as tmodels
    from ivit_tpu_torch.compat.export_torch import save_reference_checkpoint
    from ivit_tpu_torch.models import VisionTransformer
    from ivit_tpu_torch.models.convert import variables_to_numpy
    from ivit_tpu_torch.scripts import inference
    monkeypatch.setattr(tmodels, "str2model", lambda name: lambda **kw: VisionTransformer(
        **{"patch_size": 16, "embed_dim": 64, "depth": 2, "num_heads": 2, **kw}))
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    path = str(tmp_path / "ckpt.pth.tar")
    save_reference_checkpoint(variables_to_numpy(_cal_vit("cpu")),
                              {"model": "deit_small_patch16_224", "gelu_type": "ibert",
                               "softmax_type": "ibert", "layernorm_type": "ibert"}, path)
    out = {}
    for dev in ("cuda", "cpu"):
        kb.attn_block.launches = kb.mlp_block.launches = 0
        out[dev] = inference.main([
            "--weights", path, "--dataset", "synthetic", "--batch-size", "8",
            "--max-batches", "2", "--img-size", "64", "--num-classes", "10",
            "--calibration-batches", "1", "--export-engine", str(tmp_path / dev),
            "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (kb.attn_block.launches, kb.mlp_block.launches) == (4, 4)
    for k in ("top1", "top3", "top5", "images"):
        assert out["cuda"][k] == out["cpu"][k]
    for ext in (".npz", ".json"):
        assert ((tmp_path / f"cuda{ext}").read_bytes()
                == (tmp_path / f"cpu{ext}").read_bytes()), ext


def test_cuda_benchmarking_utils(cuda):
    """The H100's peaks by the card's name; the timers and the profiler on
    the card (device time by kernel name, or none where CUPTI is absent)."""
    from ivit_tpu_torch.utils import benchmarking as bench
    name = torch.cuda.get_device_name(0)
    if "H100" in name:
        assert bench.chip_peaks()["int8_tops"] == 1979e12
    else:
        with pytest.raises(ValueError, match="no peak rates"):
            bench.chip_peaks()
    x = torch.ones((256, 256), device=cuda)
    assert bench.time_inloop(lambda c: c * 1.0001, x, n_iters=10) > 0
    assert bench.time_dispatch(lambda a: a @ a, x, iters=5) > 0
    ops = bench.profile_device_ops(lambda a: a @ a, x, iters=3)
    assert all(v["us_per_iter"] > 0 for v in ops.values())


def test_cuda_engine_tp2_over_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one device): the
    ivit engine at tp 2 on the standalone kernels (the rank's 3 heads and
    768 hidden columns) bitwise the single-device engine's, two launches of
    each kernel a rank; and gloo takes the CUDA tensors of every collective
    the sharded paths use as they are (all_reduce SUM on int32, MIN and MAX
    on f32; all_gather), so no helper stages them through host memory."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_parallel_workers as workers

    from ivit_tpu_torch.parallel import launch
    res = launch.spawn(workers.cuda_engine_tp_rank, 2, backend="gloo",
                       devices=["cuda:0", "cuda:0"], init_file=str(tmp_path / "rdv"),
                       timeout=300)
    for r in res:
        assert r["equal"] and r["launches"] == (2, 2)
        assert all(r["gloo_cuda"].values()), r["gloo_cuda"]


def test_cuda_serving_two_replicas_on_one_card(cuda):
    """``ServingEngine(devices=["cuda:0", "cuda:0"])``: two replicas on the
    card's stream, each half of every batch, every answer bitwise
    ``Engine(spec)``'s, 2 x depth launches of each block kernel a batch."""
    from ivit_tpu_torch.engine.serving import ServingEngine
    spec = synthetic_spec(_small_config(2), seed=4)
    images = np.random.default_rng(8).normal(size=(16, 64, 64, 3)).astype(np.float32)
    want = Engine(spec)(torch.from_numpy(images).to(cuda)).cpu().numpy()
    with ServingEngine(spec, batch_size=8, max_wait_ms=20,
                       devices=["cuda:0", "cuda:0"]) as srv:
        assert [e.device for e in srv.engines] == [torch.device("cuda", 0)] * 2
        kb.attn_block.launches = kb.mlp_block.launches = 0
        got = srv.infer(images)
        torch.cuda.synchronize()
        batches = srv.metrics.summary()["batches"]
    np.testing.assert_array_equal(got, want)
    assert kb.attn_block.launches == kb.mlp_block.launches == 2 * 2 * batches


def test_cuda_engine_default_resolves_through_the_table(cuda):
    """``Engine(spec)`` on the card takes the H100 table: a DeiT-S-width ViT
    its ``("vit", 384)`` row (True or "ops", never the plain version), a
    Swin-T-width Swin its stage rows; the logits ``kernels=True``'s."""
    from ivit_tpu_torch.engine import dispatch
    spec = synthetic_spec(deit_small_config(depth=2, img_size=64), seed=5)
    images = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 64, 64, 3)).astype(np.float32)).to(cuda)
    eng = Engine(spec)
    fused, report = dispatch.static_choice(spec.config)
    assert eng.fusion["path_choice"] == report and report["source"] == "static-table"
    assert eng.kernels == (True if fused else "ops")
    assert torch.equal(eng(images), Engine(spec, kernels=True)(images))

    swin = _swin_spec(("ivit", "ivit", "ivit"))
    simages = images[:, :56, :56]
    seng = Engine(swin)
    paths, report = dispatch.swin_stage_choice(swin.config)
    assert seng.fusion["path_choice"] == report and seng.kernels is True
    assert seng.fusion["fused_attn_stages"] == list(paths)
    assert torch.equal(seng(simages), Engine(swin, kernels=True)(simages))


@pytest.mark.parametrize("fams", [("ivit",) * 3, ("ibert",) * 3, ("ppoly", "ppoly", "ibert")],
                         ids=["ivit", "ibert", "ppoly"])
def test_cuda_engine_probe_images(cuda, fams):
    """``Engine(spec, probe_images=x)`` on the card: an ivit ViT times the
    fused kernels against ``"ops"`` (the standalone kernels) and keeps the
    faster; an ibert or ppoly ViT and a Swin, whose unfused paths launch no
    kernel, skip the probe and keep the fused kernels (never a path without
    a kernel).  The logits the fused path's either way."""
    images = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 64, 64, 3)).astype(np.float32)).to(cuda)
    for spec, x in ((synthetic_spec(_small_config(2, fams), seed=1), images),
                    (_swin_spec(fams), images[:, :56, :56])):
        eng = Engine(spec, probe_images=x)
        choice = eng.fusion["path_choice"]
        if fams[0] == "ivit" and not hasattr(spec.config, "depths"):
            assert set(choice) == {"source", "t_fused_ms", "t_unfused_ms"}
            assert choice["source"] == "timed-probe"
            assert eng.kernels == (True if choice["t_fused_ms"] <= choice["t_unfused_ms"]
                                   else "ops")
        else:
            assert choice["probe"].startswith("skipped") and eng.kernels is True
        kb.attn_block.launches = kb.swin_attn_block.launches = kb.mlp_block.launches = 0
        knl.shiftmax.launches = knl.shift_gelu_requant.launches = 0
        got = eng(x)
        torch.cuda.synchronize()
        assert (kb.attn_block.launches + kb.swin_attn_block.launches + kb.mlp_block.launches
                + knl.shiftmax.launches + knl.shift_gelu_requant.launches) > 0
        assert torch.equal(got, Engine(spec, kernels=True)(x))


@pytest.mark.parametrize("stages", [None, (False, True)], ids=["all", "stage1"])
@pytest.mark.parametrize("parts,attn,mlp", [
    (("attn",), (1, 1), (0, 0)),
    (("mlp",), (0, 0), (1, 1)),
    (("attn", "mlp", "mlp_nopad"), (1, 1), (0, 0)),    # widths 96 and 192
], ids=["attn", "mlp", "nopad"])
def test_cuda_swin_fuse_parts_match_plain_engine(cuda, parts, attn, mlp, stages):
    """``swin_engine_forward(fuse_parts=)`` on the kernels: each variant
    launches the half-block kernels it names (2 blocks a stage), and its
    logits equal the plain engine's."""
    from ivit_tpu_torch.engine import swin_engine_forward
    spec = _swin_spec(("ivit", "ivit", "ivit"))
    images = np.random.default_rng(7).normal(size=(3, 56, 56, 3)).astype(np.float32)
    want = swin_engine_forward(spec, images, kernels=False)
    kb.swin_attn_block.launches = kb.mlp_block.launches = 0
    got = swin_engine_forward(spec, images, stage_paths=stages, fuse_parts=parts)
    torch.cuda.synchronize()
    on = stages or (True, True)
    assert kb.swin_attn_block.launches == 2 * sum(a and s for a, s in zip(attn, on))
    assert kb.mlp_block.launches == 2 * sum(m and s for m, s in zip(mlp, on))
    assert torch.equal(got, want)


def test_cuda_spans_share_the_device_traces_clock(cuda):
    """The program's spans (``ivit_tpu_torch.utils.spans``) on the card,
    over 4 DeiT-S calls: under the device-only profiler they are recorded,
    each call's ``ivit.call`` holds the start of device work and ends inside
    the device operations' stretch, and it waits for the card nowhere (no
    ``ivit.sync``: the final LN is one ``ln_requant`` launch in each
    call's ``ivit.head``); under
    CPU + CUDA each ``ivit.call`` lies inside a ``record_function`` event
    around the call and starts within 50 us of it (the profiling session's
    first call left out, as the CPU test does); in neither trace does a
    device operation bear an ``ivit.`` name (spans enter no
    ``record_function``, which the profiler would project onto the device's
    timeline); the logits are the unprofiled call's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ivit_tpu_torch.utils import spans

    def device_ops(prof):
        return [(e.name(), e.start_ns(), e.end_ns())
                for e in prof.profiler.kineto_results.events()
                if "CUDA" in str(e.device_type())]

    eng = Engine(synthetic_spec(deit_small_config(), seed=0))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(8, 224, 224, 3)).astype(np.float32)).to(cuda)
    want = eng(x).cpu()
    spans.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            eng(x).cpu()
    recs = spans.spans()
    calls = [(r.start_ns, r.end_ns) for r in recs if r.name == "ivit.call"]
    device = device_ops(prof)
    assert len(calls) == 4 and device
    first, last = min(s for _, s, _ in device), max(e for _, _, e in device)
    for s, e in calls:
        assert first <= e <= last
        assert any(s <= o <= e for _, o, _ in device)
    assert calls[0][0] <= first
    assert not [r for r in recs if r.name == "ivit.sync"]
    heads = {r.call for r in recs
             if r.name == "ivit.kernel.ln_requant" and recs[r.parent].name == "ivit.head"}
    assert heads == {r.call for r in recs if r.name == "ivit.call"}

    spans.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with record_function("test.call"):
                got = eng(x)
            got = got.cpu()
    events = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "test.call" and "CPU" in str(e.device_type()))
    roots = [(r.start_ns, r.end_ns) for r in spans.spans() if r.name == "ivit.call"]
    assert len(events) == len(roots) == 5
    for (es, ee), (rs, re) in list(zip(events, roots))[1:]:
        assert es <= rs < es + 50_000 and re <= ee
    for ops in (device, device_ops(prof)):
        assert not [n for n, _, _ in ops if n.startswith("ivit.")]
    assert torch.equal(got, want)
