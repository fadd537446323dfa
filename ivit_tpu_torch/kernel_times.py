"""Card times of the ViT block kernels of one checkout, for comparing two.

    python ivit_tpu_torch/kernel_times.py --root CHECKOUT --label NAME

imports ``ivit_tpu_torch`` from ``CHECKOUT`` (this checkout by default),
builds its kernels, and prints one JSON line: the mean time of 50
back-to-back ``mlp_block`` and ``attn_block`` calls (CUDA events) at DeiT-S
shapes (batch 256 x 197 tokens, C 384, hidden 1536, 6 heads), for the
ivit and the ibert family, fast flags on.  Run it for two checkouts in one
call, in the order A, B, B, A, to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout whose package to time")
    ap.add_argument("--label", default="", help="a name for the output line")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
    from ivit_tpu_torch.ops.kernels import _build
    from ivit_tpu_torch.ops.kernels import block as kb
    if not kb.__file__.startswith(root):
        raise RuntimeError(f"imported {kb.__file__}, not the package under {root}")
    _build.build_all()
    dev = torch.device("cuda")

    def time_ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    rng = np.random.default_rng(0)
    out = {"label": args.label, "card": torch.cuda.get_device_name(0)}
    for fam in ("ivit", "ibert"):
        cfg = deit_small_config(depth=1, ln=fam, gelu=fam, softmax=fam)
        b = {k: torch.as_tensor(v).to(dev)
             for k, v in synthetic_spec(cfg, 0).params["blocks"][0].items()}
        x = torch.as_tensor(np.clip(np.round(rng.normal(0, 32, (256, 197, 384))),
                                    -128, 127).astype(np.int8)).to(dev)
        mlp = dict(ln_bias=b["ln2_bias_int"], m_ln=b["m_ln2"], ln_shift=b["ln2_shift"],
                   fc1_w=b["fc1_w"], fc1_b=b["fc1_b"], m_fc1=b["m_fc1"],
                   s_gelu=b["s_gelu"], m_gelu=b["m_gelu"], fc2_w=b["fc2_w"],
                   fc2_b=b["fc2_b"], m_fc2=b["m_fc2"], m_res_x=b["m_res2_x"],
                   m_res_id=b["m_res2_id"], fast_exp=True, fast_poly=True,
                   ln_base=fam, gelu_base=fam)
        attn = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
                    qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
                    m_attn=b["m_attn"], s_attn=b["s_attn"], s_exp_act=b.get("s_exp_act"),
                    m_av=b["m_av"], proj_w=b["proj_w"], proj_b=b["proj_b"],
                    m_proj=b["m_proj"], m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
                    num_heads=6, n_valid=197, fast_exp=True, fast_poly=True,
                    ln_base=fam, sm_base=fam)
        rows = x.reshape(-1, 384)
        out[f"mlp_block_{fam}_ms"] = time_ms(lambda: kb.mlp_block(rows, **mlp))
        out[f"attn_block_{fam}_ms"] = time_ms(lambda: kb.attn_block(x, **attn))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
