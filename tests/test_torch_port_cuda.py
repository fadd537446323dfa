"""The CUDA block kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one: a hand-written
kernel has no CPU mode.  The file imports nothing of JAX, so it also runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

(``--noconftest``: the suite's conftest pins JAX to the CPU.)  Shapes are
small: B 2, Np 24 of which n_valid 17 real tokens, C 64, 2 heads, MLP 256;
the DeiT-S shapes are held by ``chip_smoke.py``.  Exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ivit_tpu_torch.engine import Engine
from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
from ivit_tpu_torch.ops.kernels import block as kb

pytestmark = pytest.mark.cuda

B, NP, NV, C, HEADS = 2, 24, 17, 64, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _small_config(depth):
    return dataclasses.replace(deit_small_config(depth=depth, img_size=64),
                               embed_dim=C, num_heads=HEADS, num_classes=10)


def _block(dev):
    blk = synthetic_spec(_small_config(1), seed=3).params["blocks"][0]
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
    kb.mlp_block.launches = kb.attn_block.launches = 0
    got = Engine(spec)(images)
    torch.cuda.synchronize()
    assert (kb.mlp_block.launches, kb.attn_block.launches) == (2, 2)
    assert torch.equal(got, Engine(spec, kernels=False)(images))
    assert torch.equal(got.cpu(), Engine(spec, device="cpu", kernels=False)(images))
