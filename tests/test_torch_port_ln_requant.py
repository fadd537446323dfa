"""The LayerNorm + int8 requant outside the block kernels
(``ops/kernels/nonlinear.py::ln_requant``), on the CPU, where the wrapper
runs its plain version.

That plain version equals the engines' own chain,
``vit_int._ln_requant(_layernorm_int(...))``, at the widths and streams of
those LNs: DeiT-S's head (384 int8 cls rows, read in place from the
token stream), Swin-T's patch norm (96 int8), merges (384, 768 and 1,536
int16) and final norm (768 int16); I-LayerNorm, the ibert LN and the ibert
LN with I-BERT's integer sqrt; rows at the int16 extremes and flat rows
(the ibert LN's NaN, pinned to 0); and it counts no launch.  The fused
engines route those LNs through the wrapper and keep their logits, and
while the envelope audit records they run the chain, whose
``ln_centered`` taps it keeps.  The card tests
(``test_torch_port_cuda.py``) hold the kernel to the same plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ivit_tpu_torch.engine import Engine, vit_int
from ivit_tpu_torch.engine.swin_int import swin_engine_forward
from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                              synthetic_spec, synthetic_swin_spec)
from ivit_tpu_torch.ops.kernels import nonlinear as knl

LN_FAMILIES = {"ivit": "ivit", "ibert": "ibert", "ibert_isqrt": "ibert_use-int-sqrt_true"}
# (site, C, stream, ibert shift): the LNs the engines run outside the blocks
SITES = [("deit_head", 384, torch.int8, 0), ("swin_patch", 96, torch.int8, 0),
         ("swin_merge0", 384, torch.int16, 2), ("swin_merge1", 768, torch.int16, 2),
         ("swin_merge2", 1536, torch.int16, 3), ("swin_final", 768, torch.int16, 2)]


def _rows(c, dtype, n, seed):
    """Seeded rows, then rows at the stream's extremes: both ends, the two
    ends alternating (the widest variance), flat rows (zero variance) and
    one spike."""
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(seed)
    std = 40 if dtype == torch.int8 else 6000
    rows = np.clip(np.round(rng.normal(0, std, (n, c))), info.min, info.max)
    edge = np.zeros((6, c))
    edge[0], edge[1] = info.min, info.max
    edge[2] = np.resize([info.min, info.max], c)
    edge[3] = 17
    edge[5, c // 3] = info.max
    return torch.from_numpy(np.concatenate([rows, edge])).to(dtype)


def _leaves(c, shift, seed):
    """An LN site's spec leaves at the scale a freeze gives them (the LN's
    integers are z * 2**30 / sqrt(C) for a standard score z): the integer
    bias, the per-channel requant multiplier that puts z of 1 to 6 at the
    top of int8, and the 0-d ibert shift."""
    rng = np.random.default_rng(seed)
    unit = 2.0**30 / np.sqrt(c)
    bias = torch.from_numpy(np.floor(rng.normal(0, unit / 2, c))).float()
    m = torch.from_numpy(rng.uniform(20, 120, c) / unit).float()
    return bias, m, torch.tensor(float(shift))


@pytest.mark.parametrize("site,c,dtype,shift", SITES, ids=[s[0] for s in SITES])
@pytest.mark.parametrize("fam", sorted(LN_FAMILIES))
def test_ln_requant_plain_version_is_the_engines_chain(fam, site, c, dtype, shift):
    cfg = deit_small_config(depth=1, ln=LN_FAMILIES[fam])
    bias, m, shift_t = _leaves(c, shift, seed=c)
    x = _rows(c, dtype, 40, seed=c + shift)
    if site == "deit_head":
        # the cls rows of a [B, N, C] stream: a strided view, read in place
        x = torch.cat([x[:, None], _rows(c, dtype, 40, seed=1)[:, None].expand(-1, 5, -1)],
                      dim=1)[:, :1]
    before = knl.ln_requant.launches
    got = knl.ln_requant(x, bias, m, shift_t, ln_base=vit_int._base(cfg, "ln"),
                         use_int_sqrt=vit_int._use_int_sqrt(cfg))
    want = vit_int._ln_requant(vit_int._layernorm_int(cfg, x, bias, shift_t), m, 8)
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert torch.equal(got, want)
    assert knl.ln_requant.launches == before
    # the outputs span the int8 range; a flat row is its bias alone under
    # I-LayerNorm, and the ibert LN's NaN (a zero root), pinned to 0
    assert got.min() == -128 and got.max() == 127
    flat = torch.clamp(torch.round(bias * m), -128, 127).to(torch.int8)
    assert torch.equal(got.reshape(-1, c)[-3], flat if fam == "ivit" else 0 * flat)


def _vit(ln):
    cfg = dataclasses.replace(deit_small_config(depth=2, img_size=32, ln=ln),
                              embed_dim=64, num_heads=2, num_classes=10)
    return synthetic_spec(cfg, seed=0), _images(32)


def _swin(ln):
    cfg = swin_tiny_config(depths=(2, 2), img_size=56, embed_dim=32, ln=ln,
                           stage_heads=(1, 2), num_classes=10)
    return synthetic_swin_spec(cfg, seed=0), _images(56)


def _images(size):
    return np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(np.float32)


MODELS = {"vit": (_vit, vit_int.engine_forward, 1),
          "swin": (_swin, swin_engine_forward, 3)}   # norms outside the blocks


class _Counting:
    """A stand-in for ``knl.ln_requant`` that counts the engine's calls."""

    def __init__(self):
        self.calls, self.fn = 0, knl.ln_requant

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("ln", ["ivit", "ibert"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_fused_engines_take_the_wrapper_and_keep_their_logits(model, ln, monkeypatch):
    make, forward, norms = MODELS[model]
    spec, x = make(ln)
    want = forward(spec, x, kernels=False, device="cpu")
    counting = _Counting()
    before = counting.fn.launches
    monkeypatch.setattr(knl, "ln_requant", counting)
    assert torch.equal(forward(spec, x, kernels=False, device="cpu"), want)
    assert counting.calls == 0
    assert torch.equal(forward(spec, x, kernels=True, device="cpu"), want)
    assert counting.calls == norms
    if model == "vit":
        assert torch.equal(forward(spec, x, kernels="ops", device="cpu"), want)
        assert counting.calls == 2 * norms
    assert counting.fn.launches == before
    monkeypatch.undo()
    assert torch.equal(Engine(spec, device="cpu")(x), want)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_audit_keeps_the_chains_ln_centered_sites(model, monkeypatch):
    """Under the audit the fused engine runs the chain at the norms outside
    the blocks, so it records their ``ln_centered`` sites, equal to the
    plain engine's (the first and the last of them: the patch norm or a
    block's, and the final norm)."""
    make, forward, norms = MODELS[model]
    spec, x = make("ivit")
    counting = _Counting()
    monkeypatch.setattr(knl, "ln_requant", counting)

    def centred(kernels):
        with vit_int.audit_capture() as recs:
            forward(spec, x, kernels=kernels, device="cpu")
        return [{k: float(v) if isinstance(v, torch.Tensor) else v
                 for k, v in r.items() if k != "site"}
                for r in recs if r["kind"] == "ln_centered"]
    fused, plain = centred(True), centred(False)
    assert counting.calls == 0
    assert len(fused) == norms and len(plain) > norms
    assert fused[-1] == plain[-1]
    if model == "swin":
        assert fused[0] == plain[0]
