#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ivit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --profile   # + device time by kernel per forward

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: the CUDA kernels compiled from ``ivit_tpu_torch/csrc`` (nvcc,
   one process per source, all at once);
3. mlp_block and 4. attn_block: each kernel bitwise equal to its plain
   PyTorch version on the card, at DeiT-S shapes (batch 256 x 197 tokens,
   C 384, hidden 1536, 6 heads) with the fast-exp/fast-poly flags both on
   and both off, and at a small padded shape; kernel, plain-version and
   library (``torch._int_mm`` on the block's GEMMs) times, and the bound;
5. engine: a seeded synthetic DeiT-S ibert engine (224 px, depth 12, batch
   256) through ``Engine``: the launch counts of one forward, its logits
   bitwise equal to the unfused plain engine on the card and, for 4
   images, on the CPU; finite and image-dependent; img/s of both engines.

Then the kernel table as one JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BATCH, TOKENS = 256, 197
H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, H100 SXM data sheet
H100_BYTES = 3.35e12         # HBM3 bandwidth, H100 SXM data sheet


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(torch, fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def bound(ops, nbytes):
    t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def block_args(torch, blk, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in blk.items()}


def check_equal(torch, name, got, want, rows=None):
    if rows is not None:
        got, want = got[..., :rows, :], want[..., :rows, :]
    err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
    if not torch.equal(got, want):
        bad = (got != want).nonzero()
        raise AssertionError(f"{name}: kernel != plain version at "
                             f"{bad.shape[0]} elements (first {bad[:4].tolist()}), "
                             f"max abs err {err}")
    return err


def mlp_kwargs(b, flags):
    return dict(ln_bias=b["ln2_bias_int"], m_ln=b["m_ln2"], ln_shift=b["ln2_shift"],
                fc1_w=b["fc1_w"], fc1_b=b["fc1_b"], m_fc1=b["m_fc1"],
                s_gelu=b["s_gelu"], m_gelu=b["m_gelu"], fc2_w=b["fc2_w"],
                fc2_b=b["fc2_b"], m_fc2=b["m_fc2"], m_res_x=b["m_res2_x"],
                m_res_id=b["m_res2_id"], fast_poly=flags)


def attn_kwargs(b, flags, heads, n_valid):
    return dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
                qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
                m_attn=b["m_attn"], s_attn=b["s_attn"], s_exp_act=b["s_exp_act"],
                m_av=b["m_av"], proj_w=b["proj_w"], proj_b=b["proj_b"],
                m_proj=b["m_proj"], m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
                num_heads=heads, n_valid=n_valid, fast_exp=flags, fast_poly=flags)


def kernel_phases(torch, kb, dev):
    """Phases 3-4: each kernel against its plain version; returns the rows of
    the kernel table (launch counts filled in by the engine phase)."""
    import dataclasses

    import numpy as np

    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec

    rng = np.random.default_rng(0)

    def act(shape):
        return torch.as_tensor(np.clip(np.round(rng.normal(0, 32, shape)), -128,
                                       127).astype(np.int8)).to(dev)

    small_cfg = dataclasses.replace(deit_small_config(depth=1, img_size=64),
                                    embed_dim=64, num_heads=2, num_classes=10)
    small = block_args(torch, synthetic_spec(small_cfg, 0).params["blocks"][0], dev)
    full = block_args(torch, synthetic_spec(deit_small_config(depth=1), 0)
                      .params["blocks"][0], dev)
    rows = {}

    # --- mlp_block ---
    for flags in (True, False):
        xs = act((2 * 24, 64))
        check_equal(torch, f"mlp_block small fast={flags}",
                    kb.mlp_block(xs, **mlp_kwargs(small, flags)),
                    kb.mlp_block_ref(xs, **mlp_kwargs(small, flags)))
    x = act((BATCH * TOKENS, 384))
    errs = {}
    for flags in (True, False):
        kw = mlp_kwargs(full, flags)
        got = kb.mlp_block(x, **kw)
        torch.cuda.synchronize()
        errs[flags] = check_equal(torch, f"mlp_block fast={flags}", got,
                                  kb.mlp_block_ref(x, **kw))
    kw = mlp_kwargs(full, True)
    ms = time_ms(torch, lambda: kb.mlp_block(x, **kw), iters=20)
    plain_ms = time_ms(torch, lambda: kb.mlp_block_ref(x, **kw), iters=3, warmup=1)
    h = torch.empty((x.shape[0], full["fc1_w"].shape[1]), dtype=torch.int8, device=dev)
    lib_ms = time_ms(torch, lambda: (torch._int_mm(x, full["fc1_w"]),
                                     torch._int_mm(h, full["fc2_w"])), iters=20)
    r, c, hd = x.shape[0], 384, full["fc1_w"].shape[1]
    ops = 2 * r * c * hd * 2
    nb = nbytes(x, x, full["fc1_w"], full["fc2_w"], full["fc1_b"], full["fc2_b"],
                full["m_fc1"], full["m_fc2"], full["m_ln2"], full["ln2_bias_int"])
    b_ms, b_by = bound(ops, nb)
    rows["mlp_block"] = dict(
        name="mlp_block", route="cuda", source="ivit_tpu_torch/csrc/mlp_block.cu",
        replaces="ivit_tpu/ops/pallas/block.py:783", launches=None,
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    emit({"phase": "mlp_block", "equal": True, "shape": [r, c, hd],
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "library": "torch._int_mm fc1 + fc2", "bound_ms": b_ms,
          "bound_by": b_by, "int8_ops": ops, "bytes": nb,
          "max_abs_err": max(errs.values())})

    # --- attn_block ---
    for flags in (True, False):
        xs = act((2, 24, 64))
        check_equal(torch, f"attn_block small padded fast={flags}",
                    kb.attn_block(xs, **attn_kwargs(small, flags, 2, 17)),
                    kb.attn_block_ref(xs, **attn_kwargs(small, flags, 2, 17)),
                    rows=17)
    x = act((BATCH, TOKENS, 384))
    errs = {}
    for flags in (True, False):
        kw = attn_kwargs(full, flags, 6, TOKENS)
        got = kb.attn_block(x, **kw)
        torch.cuda.synchronize()
        errs[flags] = check_equal(torch, f"attn_block fast={flags}", got,
                                  kb.attn_block_ref(x, **kw))
    kw = attn_kwargs(full, True, 6, TOKENS)
    ms = time_ms(torch, lambda: kb.attn_block(x, **kw), iters=20)
    plain_ms = time_ms(torch, lambda: kb.attn_block_ref(x, **kw), iters=3, warmup=1)
    x2 = x.reshape(-1, 384)
    lib_ms = time_ms(torch, lambda: (torch._int_mm(x2, full["qkv_w"]),
                                     torch._int_mm(x2, full["proj_w"])), iters=20)
    r, c = x2.shape
    ops = 2 * r * (3 * c * c + c * c) + 2 * 2 * BATCH * TOKENS * TOKENS * c
    nb = nbytes(x, x, full["qkv_w"], full["proj_w"], full["qkv_b"],
                full["proj_b"], full["m_qkv"], full["m_proj"], full["m_ln1"],
                full["ln1_bias_int"])
    b_ms, b_by = bound(ops, nb)
    rows["attn_block"] = dict(
        name="attn_block", route="cuda", source="ivit_tpu_torch/csrc/attn_block.cu",
        replaces="ivit_tpu/ops/pallas/block.py:1112", launches=None,
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    emit({"phase": "attn_block", "equal": True, "shape": [BATCH, TOKENS, c, 6],
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "library": "torch._int_mm qkv + proj", "bound_ms": b_ms,
          "bound_by": b_by, "int8_ops": ops, "bytes": nb,
          "max_abs_err": max(errs.values())})
    return rows


def engine_phase(torch, kb, dev, rows, profile=False):
    """Phase 5: the DeiT-S ibert engine through the entry points."""
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec

    cfg = deit_small_config()
    spec = synthetic_spec(cfg, seed=0)
    eng = Engine(spec)                       # cuda, the kernels
    plain = Engine(spec, kernels=False)      # cuda, the unfused plain engine
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [torch.randn((BATCH, 224, 224, 3), generator=gen, device=dev)
               for _ in range(3)]

    kb.mlp_block.launches = kb.attn_block.launches = 0
    logits = eng(batches[0])
    torch.cuda.synchronize()
    launches = {"mlp_block": kb.mlp_block.launches,
                "attn_block": kb.attn_block.launches}
    if launches != {"mlp_block": cfg.depth, "attn_block": cfg.depth}:
        raise AssertionError(f"one forward launched {launches}, want "
                             f"{cfg.depth} of each")
    for name, n in launches.items():
        rows[name]["launches"] = n

    if tuple(logits.shape) != (BATCH, cfg.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    if not (logits.std(dim=0) > 0).any():
        raise AssertionError("logits constant across images")
    want = plain(batches[0])
    if not torch.equal(logits, want):
        raise AssertionError(
            f"kernel engine != plain engine on the card: max abs diff "
            f"{(logits - want).abs().max().item()}")
    cpu = Engine(spec, device="cpu", kernels=False)(batches[0][:4].cpu())
    if not torch.equal(logits[:4].cpu(), cpu):
        raise AssertionError(
            f"kernel engine != plain engine on the CPU (4 images): max abs "
            f"diff {(logits[:4].cpu() - cpu).abs().max().item()}")

    def img_per_s(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(batches[i % len(batches)])
        torch.cuda.synchronize()
        return n * BATCH / (time.perf_counter() - t0)

    ips = img_per_s(eng, 6)
    plain_ips = img_per_s(plain, 2)
    emit({"phase": "engine", "config": "deit_small ibert 224px depth 12 (synthetic, seed 0)",
          "batch": BATCH, "launches_per_forward": launches,
          "equal_plain_cuda": True, "equal_plain_cpu_4img": True,
          "img_per_s": ips, "plain_img_per_s": plain_ips,
          "logits_std": logits.std().item()})
    if profile:
        emit(profile_forward(torch, eng, batches[0]))


def profile_forward(torch, eng, images, n=3):
    """Device time by kernel over ``n`` forwards (torch.profiler, CUDA
    activity), and the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # device-side events only: a CPU op's self device time is the time of
    # the kernels it launched, which are listed again under their own names
    kernels = {a.key: a.self_device_time_total / 1e3 / n
               for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0}
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": "profile", "forwards": n, "wall_ms_per_forward": wall_ms,
            "device_ms_per_forward": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the engine forward")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    try:
        from ivit_tpu_torch.ops.kernels import _build
        from ivit_tpu_torch.ops.kernels import block as kb
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    times = _build.build_all()
    ptxas = {n: [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
             for n, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": times, "ptxas": ptxas})
    rows = kernel_phases(torch, kb, dev)
    engine_phase(torch, kb, dev, rows, profile=args.profile)
    emit({"kernels": list(rows.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
