"""Swin-B at 384 px with 12 x 12 windows (``swin_base_patch4_window12_384``):
windows of 144 tokens, past the one-warp window core's 64, on the
``swin_attn_block`` kernel's split-key core, and LayerNorm rows of 2,048
channels (Swin-B's last merge) on ``ln_requant``.

On the CPU: the port's ``Engine`` against the benchmark's plain Swin
reference (``gpubench/reference/swin.py``) on its seeded specs
(``gpubench/specmaker.py``) at window 12, cut to 96 px and two stages (stage
0: four shifted windows of 144 tokens an image; stage 1: one), ivit and
ibert families, logits equal; the registry's geometry; the
``wide_launches`` delta on ``ivit.call`` and the benchmark metrics that read
it and ``token_order_launches``.

On a card (``cuda`` marker, skipped without one; no JAX here, so

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_swin_b384.py -q

runs them where only PyTorch is installed): the split-key core at 144
tokens, unshifted and shifted, every family and table form, int8 and int16
streams, the integer-sqrt LN, and at 81 and 169 tokens with head dims 32 and
128; on the token-order stream (``grid``, the roll and partition as the
kernel's row map) against the windowed call between the copies;
``ln_requant`` at C 2,048; Swin-B at 224 and 384 px at its published
widths, the fused ``Engine`` against the plain engine.  Exact equality
throughout.
"""

import inspect
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpubench import cells, program, program_spans, specmaker
from gpubench import trace as gtrace
from gpubench.harness import Run
from gpubench.reference import common
from ivit_tpu_torch.engine import Engine, dispatch
from ivit_tpu_torch.engine.synthetic import (swin_tiny_config, synthetic_swin_spec,
                                              with_tables)
from ivit_tpu_torch.models import str2model
from ivit_tpu_torch.models import swin as swin_models
from ivit_tpu_torch.models.swin import from_windows, stage_geometry, to_windows
from ivit_tpu_torch.ops.kernels import block as kb
from ivit_tpu_torch.ops.kernels import nonlinear as knl
from ivit_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# window 12 at 96 px: a 24 x 24 patch grid, stage 0 four windows an image
# (its second block shifted), stage 1 one 12 x 12 window (unshifted)
CUT = {"img_size": 96, "depths": [2, 2], "stage_heads": [4, 8]}


def _benchmark_config(fam):
    with open(os.path.join(ROOT, "gpubench/configs/swin_b384_ivit.json")) as f:
        cfg = json.load(f)
    return {**cfg, **CUT, "gelu_type": fam, "softmax_type": fam, "layernorm_type": fam}


@pytest.mark.parametrize("fam", ["ivit", "ibert"])
def test_engine_equals_the_benchmark_reference_at_window_12(fam):
    cfg = _benchmark_config(fam)
    spec_cfg, params = specmaker.make(cfg, 2**31 + 22)
    assert [tuple(e) for e in spec_cfg["layout"]] == [
        ("block", 0, 0), ("block", 0, 6), ("merge", 0, 0), ("block", 1, 0),
        ("block", 1, 0)]
    ref = cells.reference(cfg)
    assert [(b["seqs"], b["n"], b["masked"]) for b in ref.blocks(spec_cfg, 1)] == [
        (4, 144, 0), (4, 144, 4), (1, 144, 0), (1, 144, 0)]
    x = torch.randn(2, 96, 96, 3, generator=torch.Generator().manual_seed(3))
    got = program.build(spec_cfg, params, "cpu")(x)
    want = ref.forward(spec_cfg, common.tensors(params, "cpu"), x)
    assert torch.equal(got, want)
    assert float(want.std()) > 0


def test_registry_carries_the_published_swin_b384_geometry(monkeypatch):
    """Swin-B at 384 px (arXiv:2103.14030 Table 1): patch 4, C 128, depths
    2-2-18-2, heads 4-8-16-32 (32 channels each), window 12, MLP ratio 4,
    1,000 classes; stage 3's 12 x 12 grid is one window and is not
    shifted."""
    params = inspect.signature(swin_models.SwinTransformer).parameters
    assert (params["mlp_ratio"].default, params["num_classes"].default) == (4.0, 1000)
    made = {}
    monkeypatch.setattr(swin_models, "SwinTransformer", lambda **kw: made.update(kw))
    str2model("swin_base_patch4_window12_384")()
    assert made == {"img_size": 384, "patch_size": 4, "window_size": 12,
                    "embed_dim": 128, "depths": (2, 2, 18, 2),
                    "num_heads": (4, 8, 16, 32)}
    grid = 384 // 4
    assert [stage_geometry(grid >> s, 12, 6) for s in range(4)] == [
        (12, 6), (12, 6), (12, 6), (12, 0)]
    assert [(grid >> s) ** 2 // 144 for s in range(4)] == [64, 16, 4, 1]


def _wide_counting(real):
    """A stand-in for the wrapper that counts its split-key calls as the
    card's wrapper does (on the CPU the wrapper runs its plain version): a
    window's tokens are ws**2 of a token-order call's ``grid``."""
    def wrapper(xw, **kw):
        n = kw["grid"][1] ** 2 if kw.get("grid") else xw.shape[1]
        wrapper.wide_launches += n > kb.SWIN_SPLIT_TOKENS
        return real(xw, **kw)
    wrapper.wide_launches = wrapper.transposes = wrapper.token_order_launches = 0
    return wrapper


def test_call_carries_its_wide_launches(monkeypatch):
    monkeypatch.setattr(kb, "swin_attn_block", _wide_counting(kb.swin_attn_block))
    x = np.random.default_rng(1).normal(size=(1, 96, 96, 3)).astype(np.float32)
    specs = {12: synthetic_swin_spec(swin_tiny_config(
                 depths=(2, 2), img_size=96, embed_dim=32, stage_heads=(1, 2),
                 window_size=12, num_classes=10), seed=0),
             8: synthetic_swin_spec(swin_tiny_config(
                 depths=(2, 2), img_size=64, embed_dim=32, stage_heads=(1, 2),
                 window_size=8, num_classes=10), seed=0)}
    for window, want in ((12, 4), (8, 0)):
        eng = Engine(specs[window], device="cpu")
        images = x[:, :8 * window, :8 * window]
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            eng(images)
            eng(images)
        roots = [r for r in spans.spans() if r.name == "ivit.call"]
        assert [r.attrs["wide_launches"] for r in roots] == [want, want]
        spans.clear()


def test_wide_launches_reader_reads_the_calls_attribute(monkeypatch):
    """The benchmark's ``wide_launches_per_call``: the median of the calls'
    attribute over the device-only stretch; None from a program whose calls
    carry no such attribute (the parent of this metric)."""
    def rec(call, start, end, attrs):
        return types.SimpleNamespace(name="ivit.call", start_ns=int(start * 1e9),
                                     end_ns=int(end * 1e9), parent=None, call=call,
                                     attrs=attrs)
    mod = types.SimpleNamespace(recs=[])
    mod.spans = lambda: list(mod.recs)
    monkeypatch.setitem(sys.modules, program_spans.MODULE, mod)
    ops = [gtrace.Op("k", 10.0, 11.0), gtrace.Op("k", 12.0, 13.0)]
    trace = gtrace.Trace(ops, [], [], (10.0, 14.0), 2)
    run = Run(cfg={}, traffic={}, batch=64, blocks=[], macs_per_image=1, img_per_s=1.0,
              enqueue_s=[], trace=trace)
    reader = cells.metric("wide_launches_per_call")
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == ("Kernel wrappers", "launches",
                                                         "img_per_s")
    mod.recs = [rec(0, 10.0, 11.5, {"transposes": 24, "wide_launches": 24}),
                rec(1, 12.0, 13.5, {"transposes": 24, "wide_launches": 24})]
    assert reader.read(run) == 24
    mod.recs = [rec(0, 10.0, 11.5, {"transposes": 24}),
                rec(1, 12.0, 13.5, {"transposes": 24})]
    assert reader.read(run) is None


def test_token_order_launches_reader_reads_the_calls_attribute(monkeypatch):
    """The benchmark's ``token_order_launches_per_call``: the median of the
    calls' attribute over the device-only stretch; None from a program
    whose calls carry no such attribute (the parent of this metric)."""
    def rec(call, start, end, attrs):
        return types.SimpleNamespace(name="ivit.call", start_ns=int(start * 1e9),
                                     end_ns=int(end * 1e9), parent=None, call=call,
                                     attrs=attrs)
    mod = types.SimpleNamespace(recs=[])
    mod.spans = lambda: list(mod.recs)
    monkeypatch.setitem(sys.modules, program_spans.MODULE, mod)
    ops = [gtrace.Op("k", 10.0, 11.0), gtrace.Op("k", 12.0, 13.0)]
    trace = gtrace.Trace(ops, [], [], (10.0, 14.0), 2)
    run = Run(cfg={}, traffic={}, batch=64, blocks=[], macs_per_image=1, img_per_s=1.0,
              enqueue_s=[], trace=trace)
    reader = cells.metric("token_order_launches_per_call")
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == ("Kernel wrappers", "launches",
                                                         "img_per_s")
    attrs = {"transposes": 24, "wide_launches": 24}
    mod.recs = [rec(0, 10.0, 11.5, attrs | {"token_order_launches": 24}),
                rec(1, 12.0, 13.5, attrs | {"token_order_launches": 24})]
    assert reader.read(run) == 24
    mod.recs = [rec(0, 10.0, 11.5, attrs), rec(1, 12.0, 13.5, attrs)]
    assert reader.read(run) is None


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


PPOLY = "ppoly_backend_ibert_optim-bounds_false"
# (spec families (gelu, softmax, ln), the kernel's (gelu, softmax, ln))
FAMILIES = {"ivit": (("ivit",) * 3, ("ivit",) * 3),
            "ibert": (("ibert",) * 3, ("ibert",) * 3),
            "ivit_ibert_ln": (("ivit", "ivit", "ibert"), ("ivit", "ivit", "ibert")),
            "ppoly": ((PPOLY, PPOLY, "ivit"), ("ppoly", "ppoly", "ivit"))}


def _window_spec(spec_mix, window=12, heads=4, tables=False):
    """One stage at C 128 of four windows an image (``8 * window`` px): its
    first block unshifted, its second shifted."""
    gelu, softmax, ln = spec_mix
    spec = synthetic_swin_spec(swin_tiny_config(
        depths=(2,), img_size=8 * window, embed_dim=128, stage_heads=(heads,),
        window_size=window, num_classes=10, gelu=gelu, softmax=softmax, ln=ln), seed=5)
    return with_tables(spec) if tables else spec


def _blocks(spec, dev):
    """(block tensors, heads, shift) of each block of a one-stage spec."""
    return [({k: torch.as_tensor(v).to(dev) for k, v in blk.items()},
             spec.config.stage_heads[0], shift)
            for (kind, _, shift), blk in zip(spec.config.layout, spec.params["blocks"])
            if kind == "block"]


def _stream(dev, shape, bits, seed):
    lim = 2 ** (bits - 1)
    x = np.clip(np.round(np.random.default_rng(seed).normal(0, lim / 4, shape)),
                -lim, lim - 1)
    return torch.from_numpy(x.astype(np.int16 if bits > 8 else np.int8)).to(dev)


def _attn_kw(b, mix, fast, heads, shift):
    kw = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
              qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
              m_attn=b["m_attn"], m_attn2=b["m_attn2"], s_attn=b["s_attn"],
              rel_addend=b["rel_bias_addend"],
              mask_addend=b["mask_int"] if shift else None,
              s_exp_act=b.get("s_exp_act"), m_av=b["m_av"], proj_w=b["proj_w"],
              proj_b=b["proj_b"], m_proj=b["m_proj"], m_res_x=b["m_res1_x"],
              m_res_id=b["m_res1_id"], num_heads=heads, n_windows=4,
              fast_exp=fast, fast_poly=fast, sm_base=mix[1], ln_base=mix[2])
    if mix[1] == "ppoly":
        kw |= dict(sm_bounds=b["sm_bounds"], sm_coeffs=b["sm_coeffs"], exp_bits=16)
    return kw


def _wide(x, kw):
    """One kernel call, held to its plain version; one wide launch."""
    before = (kb.swin_attn_block.launches, kb.swin_attn_block.wide_launches)
    got = kb.swin_attn_block(x, **kw)
    torch.cuda.synchronize()
    assert (kb.swin_attn_block.launches, kb.swin_attn_block.wide_launches) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == torch.int16
    return got, kb.swin_attn_block_ref(x, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_cuda_split_key_core_matches_plain_version(cuda, fam):
    """Windows of 144 tokens, the unshifted and the shifted block (masked
    scores, which the ppoly core runs through its polynomial), int16 and
    int8 (a merge's output) streams, fast flags both ways, the LN in the
    kernel and hoisted."""
    spec_mix, mix = FAMILIES[fam]
    for i, (b, heads, shift) in enumerate(_blocks(_window_spec(spec_mix), cuda)):
        for bits in (16, 8):
            x = _stream(cuda, (8, 144, 128), bits, seed=i + bits)
            for fast in (False, True):
                kw = _attn_kw(b, mix, fast, heads, shift)
                for ln_in in (None, kb._ln8(x, mix[2], kw["ln_bias"], kw["ln_shift"],
                                            kw["m_ln"], None)):
                    got, want = _wide(x, kw | dict(ln_in=ln_in))
                    assert torch.equal(got, want), (i, bits, fast, ln_in is None)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", ["ivit", "ibert", "ppoly"])
def test_cuda_split_key_core_table_forms(cuda, fam, monkeypatch):
    """The table forms at 144 tokens (``IVIT_LUT``): a freeze's tables, both
    ivit row sums, the shifted block with ``sm_sat`` (ivit, ibert; a shifted
    ppoly block keeps its tower), equal to the plain version with the same
    tables and to the towers."""
    monkeypatch.setenv("IVIT_LUT", "1")
    spec_mix, mix = FAMILIES[fam]
    spec = _window_spec(spec_mix, tables=True)
    for i, (b, heads, shift) in enumerate(_blocks(spec, cuda)):
        assert ("sm_sat" in b) == (shift > 0 and fam != "ppoly")
        x = _stream(cuda, (8, 144, 128), 16, seed=50 + i)
        kw = _attn_kw(b, mix, True, heads, shift)
        for sum_i32 in ((False, True) if fam == "ivit" else (False,)):
            tables = dict(sm_lut=b["sm_lut"], sm_sum_i32=sum_i32, sm_sat=b.get("sm_sat"))
            gated = tables if "sm_sat" in b or not shift else {}   # block.py:1486
            before = kb.swin_attn_block.lut_launches
            got = kb.swin_attn_block(x, **kw, **tables)
            torch.cuda.synchronize()
            assert kb.swin_attn_block.lut_launches == before + bool(gated)
            assert torch.equal(got, kb.swin_attn_block_ref(x, **kw, **gated)), (i, sum_i32)
            monkeypatch.delenv("IVIT_LUT")
            assert torch.equal(got, kb.swin_attn_block(x, **kw, **tables)), (i, sum_i32)
            monkeypatch.setenv("IVIT_LUT", "1")


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(FAMILIES) + ["ivit_tables"])
def test_cuda_split_key_core_token_order(cuda, fam, monkeypatch):
    """The split-key chain on the token-order stream [2, 576, 128] (``grid``
    (24, 12, shift): four windows of 144 an image, the kernel's row map),
    unshifted and shifted by 6, int16 and int8, the LN in the kernel and
    hoisted (and the ivit table form with ``sm_sat``): equal to the windowed
    call between the roll + partition and reverse + roll copies, one
    token-order and one wide launch a call."""
    tables = fam.endswith("_tables")
    spec_mix, mix = FAMILIES[fam.removesuffix("_tables")]
    if tables:
        monkeypatch.setenv("IVIT_LUT", "1")
    for i, (b, heads, shift) in enumerate(_blocks(_window_spec(spec_mix, tables=tables),
                                                  cuda)):
        kw = _attn_kw(b, mix, True, heads, shift)
        if tables:
            kw |= dict(sm_lut=b["sm_lut"], sm_sum_i32=False, sm_sat=b.get("sm_sat"))
        for bits in (16, 8):
            x = _stream(cuda, (2, 576, 128), bits, seed=90 + i + bits)
            for ln_in in (None, kb._ln8(x, mix[2], kw["ln_bias"], kw["ln_shift"],
                                        kw["m_ln"], None)):
                fn = kb.swin_attn_block
                before = (fn.token_order_launches, fn.wide_launches)
                got = fn(x, ln_in=ln_in, grid=(24, 12, shift), **kw)
                torch.cuda.synchronize()
                assert (fn.token_order_launches, fn.wide_launches) == (
                    before[0] + 1, before[1] + 1)
                assert got.dtype == torch.int16 and got.shape == x.shape

                def win(t):
                    return None if t is None else to_windows(t, 2, 24, 128, 12, shift)
                want = from_windows(fn(win(x), ln_in=win(ln_in), **kw), 2, 24, 128, 12,
                                    shift)
                assert torch.equal(got, want), (i, bits, ln_in is None)


@pytest.mark.cuda
def test_cuda_split_key_core_int_sqrt_ln(cuda):
    """The ibert LN with I-BERT's integer sqrt in the split-key chain."""
    spec_mix, mix = FAMILIES["ibert"]
    for i, (b, heads, shift) in enumerate(_blocks(_window_spec(spec_mix), cuda)):
        x = _stream(cuda, (8, 144, 128), 16, seed=60 + i)
        kw = _attn_kw(b, mix, True, heads, shift) | dict(use_int_sqrt=True)
        before = kb.swin_attn_block.int_sqrt_launches
        got, want = _wide(x, kw)
        assert kb.swin_attn_block.int_sqrt_launches == before + 1
        assert torch.equal(got, want), i


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [4, 1], ids=["dh32", "dh128"])
@pytest.mark.parametrize("window", [9, 12, 13], ids=["n81", "n144", "n169"])
def test_cuda_split_key_core_edge_windows(cuda, window, heads):
    """Key counts the three warps split unevenly (81: the third holds none;
    169: two chunks, the last ragged), head dims 32 and 128, the ivit and
    ibert families, int16 and int8 input; a window of 196 tokens raises."""
    n = window * window
    for family in ("ivit", "ibert"):
        mix = (family,) * 3
        for i, (b, h, shift) in enumerate(_blocks(_window_spec(mix, window, heads), cuda)):
            for bits in (16, 8):
                x = _stream(cuda, (8, n, 128), bits, seed=70 + i + bits)
                got, want = _wide(x, _attn_kw(b, mix, True, h, shift))
                assert torch.equal(got, want), (family, shift, bits)
    mix = ("ivit",) * 3
    b, h, _ = _blocks(_window_spec(mix, 14, heads), cuda)[0]
    before = kb.swin_attn_block.launches
    with pytest.raises(ValueError, match="192 tokens"):
        kb.swin_attn_block(_stream(cuda, (8, 196, 128), 16, 0),
                           **_attn_kw(b, mix, True, h, 0))
    assert kb.swin_attn_block.launches == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16], ids=["int8", "int16"])
@pytest.mark.parametrize("fam,isqrt", [("ivit", False), ("ibert", False), ("ibert", True)],
                         ids=["ivit", "ibert", "ibert_isqrt"])
def test_cuda_ln_requant_at_2048_channels(cuda, fam, isqrt, dtype):
    """Swin-B's last merge norm, 2,048 channels (Swin-B/384: 64 x 144 rows),
    on rows at the stream's extremes, equal to the plain version; one
    launch; a flat ibert row's NaN pinned to 0."""
    c = 2048
    rng = np.random.default_rng(c)
    unit = 2.0**30 / np.sqrt(c)
    bias = torch.from_numpy(np.floor(rng.normal(0, unit / 2, c))).float().to(cuda)
    m = torch.from_numpy(rng.uniform(20, 120, c) / unit).float().to(cuda)
    shift = torch.tensor(5.0 if dtype == torch.int16 else 0.0, device=cuda)
    x = _ln_rows(cuda, c, dtype, 300, seed=7)
    before = knl.ln_requant.launches
    got = knl.ln_requant(x, bias, m, shift, ln_base=fam, use_int_sqrt=isqrt)
    torch.cuda.synchronize()
    assert knl.ln_requant.launches == before + 1
    assert torch.equal(got, knl.ln_requant_ref(x, bias, m, shift, ln_base=fam,
                                                use_int_sqrt=isqrt))
    assert (got[-2] == 0).all() if fam == "ibert" else got[-2].ne(0).any()
    assert got.min() == -128 and got.max() == 127


@pytest.mark.cuda
@pytest.mark.parametrize("img,window,wide", [(224, 7, 0), (384, 12, 24)],
                         ids=["224px", "384px"])
def test_cuda_swin_b_engine_matches_plain_engine(cuda, img, window, wide):
    """Swin-B at its published widths (C 128 to 1,024, depths 2-2-18-2,
    heads 4-8-16-32), batch 2: ``Engine(spec)`` with its defaults fused (24
    ``swin_attn_block`` and ``mlp_block`` launches, 5 ``ln_requant``: the
    patch norm, the merges up to 2,048 channels, the final norm) equals the
    plain engine; the 384 px model's 24 window attentions take the split-key
    core, which ``ivit.call`` carries as ``wide_launches``."""
    spec = synthetic_swin_spec(swin_tiny_config(
        depths=(2, 2, 18, 2), img_size=img, embed_dim=128, stage_heads=(4, 8, 16, 32),
        window_size=window), seed=11)
    x = torch.randn(2, img, img, 3, generator=torch.Generator().manual_seed(4)).to(cuda)
    want = Engine(spec, kernels=False)(x)
    eng = Engine(spec)
    # no stage width of Swin-B has a row in the H100 table: every stage fused
    assert not {128, 256, 512, 1024} & set(dispatch.MEASURED_SWIN_STAGE)
    assert eng.kernels is True and all(eng.fusion["fused_attn_stages"])
    fns = (kb.swin_attn_block, kb.mlp_block, knl.ln_requant)
    counters = (kb.swin_attn_block.wide_launches, kb.swin_attn_block.token_order_launches)
    before = [f.launches for f in fns] + list(counters)
    spans.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        got = eng(x)
        torch.cuda.synchronize()
    after = [f.launches for f in fns] + [kb.swin_attn_block.wide_launches,
                                         kb.swin_attn_block.token_order_launches]
    # every block on the token-order stream: no roll or partition copy
    assert [a - b for a, b in zip(after, before)] == [24, 24, 5, wide, 24]
    roots = [r for r in spans.spans() if r.name == "ivit.call"]
    assert [r.attrs["wide_launches"] for r in roots] == [wide]
    assert [r.attrs["token_order_launches"] for r in roots] == [24]
    spans.clear()
    assert torch.equal(got, want)
    assert float(want.std()) > 0
