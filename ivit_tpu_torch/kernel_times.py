"""Card times of the block kernels of one checkout, for comparing two.

    python ivit_tpu_torch/kernel_times.py --root CHECKOUT --label NAME

imports ``ivit_tpu_torch`` from ``CHECKOUT`` (this checkout by default),
builds its kernels, and prints one JSON line: the mean time of 50
back-to-back calls (CUDA events), fast flags on, the ivit, ibert and
ppoly families (ppoly: GELU and softmax ``ppoly_backend_ibert`` with the
ibert LN on DeiT-S and the ivit LN on Swin-T, fast-div on), of
  * ``mlp_block`` and ``attn_block`` at DeiT-S shapes (batch 256 x 197
    tokens, C 384, hidden 1536, 6 heads);
  * ``swin_attn_block`` and the Swin form of ``mlp_block`` at the four
    Swin-T stage shapes of batch 64 ([4096, 49, 96] to [64, 49, 768]
    windows, the stage's last block: shifted where the stage has one; for
    ppoly also the first, unshifted block, ``*_unshifted_*``);
  * the standalone ``shift_gelu_requant`` at [50,432, 1536] and
    ``shiftmax`` at [256, 6, 197, 197] (DeiT-S's hidden rows and scores,
    the synthetic ivit block's scales, fast quotient on; ``shiftmax`` also
    with the rdiv quotient, ``shiftmax_rdiv_ms``, and into 16-bit
    probabilities, ``shiftmax_16bit_ms``), and ptxas's registers and
    spill bytes of the standalone kernels (``nonlinear_ptxas``);
and, for both attention kernels, the device time of each of the three
launches of their chain (LN + qkv, attention core, proj), summed by kernel
name over 10 calls under ``torch.profiler`` (``*_split_ms``; "other" is
the wrapper's weight transposes).  Run it for two checkouts in one call,
in the order A, B, B, A, to compare them on one card.  ``--only
nonlinear`` times the standalone kernels alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SWIN_BATCH, SWIN_GRID, WIN = 64, 56, 49
PPOLY = "ppoly_backend_ibert"
# (gelu, softmax, ln) of each family's DeiT-S and Swin-T specs
FAMILIES = {"ivit": (("ivit",) * 3, ("ivit",) * 3),
            "ibert": (("ibert",) * 3, ("ibert",) * 3),
            "ppoly": ((PPOLY, PPOLY, "ibert"), (PPOLY, PPOLY, "ivit"))}


def ppoly_kwargs(b, which):
    """The ppoly leaves a block kernel takes (none for another family)."""
    if which == "gelu" and "gelu_bounds" in b:
        return dict(gelu_bounds=b["gelu_bounds"], gelu_coeffs=b["gelu_coeffs"],
                    gelu_s_out=b["gelu_s_out"], gelu_fastdiv=True,
                    gelu_s_out_c=b["gelu_s_out_c"], gelu_patch_h=b["gelu_patch_h"],
                    gelu_patch_d=b["gelu_patch_d"])
    if which == "softmax" and "sm_bounds" in b:
        return dict(sm_bounds=b["sm_bounds"], sm_coeffs=b["sm_coeffs"], exp_bits=16)
    return {}


def launch_role(name):
    """The chain launch a kernel name belongs to."""
    for role in ("ln_qkv", "core", "proj_"):
        if role in name:
            return role.rstrip("_")
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout whose package to time")
    ap.add_argument("--label", default="", help="a name for the output line")
    ap.add_argument("--only", choices=("all", "nonlinear"), default="all",
                    help="time every kernel, or the standalone ones alone")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                                  synthetic_spec, synthetic_swin_spec)
    from ivit_tpu_torch.ops.kernels import _build
    from ivit_tpu_torch.ops.kernels import block as kb
    from ivit_tpu_torch.ops.kernels import nonlinear as knl
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

    def split_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {"ln_qkv": 0.0, "core": 0.0, "proj": 0.0, "other": 0.0}
        for a in prof.key_averages():
            if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0:
                out[launch_role(a.key)] += a.self_device_time_total / 1e3 / iters
        return out

    def tensors(blk):
        return {k: torch.as_tensor(v).to(dev) for k, v in blk.items()}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    out = {"label": args.label, "card": torch.cuda.get_device_name(0),
           "nvidia_smi": smi,
           "nonlinear_ptxas": _build.ptxas_report(_build.compiler_logs()["nonlinear"])}
    x = torch.as_tensor(np.clip(np.round(rng.normal(0, 32, (256, 197, 384))),
                                -128, 127).astype(np.int8)).to(dev)
    rows = x.reshape(-1, 384)
    for fam, ((gelu, softmax, ln), _) in FAMILIES.items():
        if args.only == "nonlinear" and fam != "ivit":
            continue
        cfg = deit_small_config(depth=1, ln=ln, gelu=gelu, softmax=softmax)
        b = tensors(synthetic_spec(cfg, 0).params["blocks"][0])
        mlp = dict(ln_bias=b["ln2_bias_int"], m_ln=b["m_ln2"], ln_shift=b["ln2_shift"],
                   fc1_w=b["fc1_w"], fc1_b=b["fc1_b"], m_fc1=b["m_fc1"],
                   s_gelu=b["s_gelu"], m_gelu=b["m_gelu"], fc2_w=b["fc2_w"],
                   fc2_b=b["fc2_b"], m_fc2=b["m_fc2"], m_res_x=b["m_res2_x"],
                   m_res_id=b["m_res2_id"], fast_exp=True, fast_poly=True,
                   ln_base=ln, gelu_base=fam,
                   **ppoly_kwargs(b, "gelu"))
        attn = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
                    qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
                    m_attn=b["m_attn"], s_attn=b["s_attn"], s_exp_act=b.get("s_exp_act"),
                    m_av=b["m_av"], proj_w=b["proj_w"], proj_b=b["proj_b"],
                    m_proj=b["m_proj"], m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
                    num_heads=6, n_valid=197, fast_exp=True, fast_poly=True,
                    ln_base=ln, sm_base=fam,
                    **ppoly_kwargs(b, "softmax"))
        if args.only == "all":
            out[f"mlp_block_{fam}_ms"] = time_ms(lambda: kb.mlp_block(rows, **mlp))
            out[f"attn_block_{fam}_ms"] = time_ms(lambda: kb.attn_block(x, **attn))
            out[f"attn_block_{fam}_split_ms"] = split_ms(
                lambda: kb.attn_block(x, **attn))
        if fam == "ivit":
            h = torch.as_tensor(np.clip(np.round(rng.normal(0, 32, (rows.shape[0], 1536))),
                                        -128, 127).astype(np.int8)).to(dev)
            out["shift_gelu_requant_ms"] = time_ms(lambda: knl.shift_gelu_requant(
                h, b["s_gelu"], b["m_gelu"], fast_q=True))
            scores = torch.as_tensor(rng.integers(-127, 128, (256, 6, 197, 197))
                                     .astype(np.int8)).to(dev)
            for key, bits, fq in (("shiftmax_ms", 8, True), ("shiftmax_rdiv_ms", 8, False),
                                  ("shiftmax_16bit_ms", 16, True)):
                out[key] = time_ms(lambda: knl.shiftmax(scores, b["s_attn"], bits,
                                                        fast_q=fq))
            del h, scores

    if args.only == "nonlinear":
        print(json.dumps(out), flush=True)
        return 0

    for fam, (_, (gelu, softmax, ln)) in FAMILIES.items():
        spec = synthetic_swin_spec(swin_tiny_config(ln=ln, gelu=gelu, softmax=softmax),
                                   seed=0)
        first, last = {}, {}
        for (kind, stage, shift), blk in zip(spec.config.layout, spec.params["blocks"]):
            if kind == "block":
                first.setdefault(stage, (shift, blk))
                last[stage] = (shift, blk)
        attn_ms, split, mlp_ms, unshifted_ms = [], [], [], []
        for st in sorted(last):
            shift, blk = last[st]
            b = tensors(blk)
            c, heads = spec.config.embed_dim * 2 ** st, spec.config.stage_heads[st]
            res = SWIN_GRID // 2 ** st
            nw = (res // min(7, res)) ** 2
            xw = torch.as_tensor(np.clip(np.round(rng.normal(
                0, 2 ** 13, (SWIN_BATCH * nw, WIN, c))), -2 ** 15, 2 ** 15 - 1)
                .astype(np.int16)).to(dev)
            kw = dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
                      qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
                      m_attn=b["m_attn"], m_attn2=b["m_attn2"], s_attn=b["s_attn"],
                      rel_addend=b["rel_bias_addend"],
                      mask_addend=b["mask_int"] if shift else None,
                      s_exp_act=b.get("s_exp_act"), m_av=b["m_av"],
                      proj_w=b["proj_w"], proj_b=b["proj_b"], m_proj=b["m_proj"],
                      m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
                      num_heads=heads, n_windows=nw, fast_exp=True, fast_poly=True,
                      sm_base=fam, ln_base=ln, **ppoly_kwargs(b, "softmax"))
            attn_ms.append(time_ms(lambda: kb.swin_attn_block(xw, **kw)))
            split.append(split_ms(lambda: kb.swin_attn_block(xw, **kw)))
            if fam == "ppoly":
                b0 = tensors(first[st][1])
                kw0 = kw | dict(mask_addend=None, rel_addend=b0["rel_bias_addend"],
                                **ppoly_kwargs(b0, "softmax"))
                unshifted_ms.append(time_ms(lambda: kb.swin_attn_block(xw, **kw0)))
            mkw = dict(ln_bias=b["ln2_bias_int"], m_ln=b["m_ln2"], ln_shift=b["ln2_shift"],
                       fc1_w=b["fc1_w"], fc1_b=b["fc1_b"], m_fc1=b["m_fc1"],
                       s_gelu=b["s_gelu"], m_gelu=b["m_gelu"], fc2_w=b["fc2_w"],
                       fc2_b=b["fc2_b"], m_fc2=b["m_fc2"], m_res_x=b["m_res2_x"],
                       m_res_id=b["m_res2_id"], mlp_bits=8, out_bits=16,
                       fast_exp=True, fast_poly=True, ln_base=ln, gelu_base=fam,
                       **ppoly_kwargs(b, "gelu"))
            xr = xw.reshape(-1, c)
            mlp_ms.append(time_ms(lambda: kb.mlp_block(xr, **mkw)))
        out[f"swin_attn_block_{fam}_ms_by_stage"] = attn_ms
        out[f"swin_attn_block_{fam}_split_ms_by_stage"] = split
        out[f"mlp_block_swin_{fam}_ms_by_stage"] = mlp_ms
        if unshifted_ms:
            out[f"swin_attn_block_{fam}_unshifted_ms_by_stage"] = unshifted_ms
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
