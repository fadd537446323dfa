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
   C 384, hidden 1536, 6 heads): the ibert family with the fast-exp/
   fast-poly flags both on and both off, the ivit family and the two mixes
   of ivit and ibert LN, and the hoisted-LN (``ln_in``) form; and at a
   small padded shape; kernel times of the ibert and the ivit variant,
   plain-version and library (``torch._int_mm`` on the block's GEMMs)
   times, and the bound;
5. shiftmax and 6. shift_gelu_requant: each standalone kernel bitwise equal
   to its plain version at DeiT-S shapes ([256, 6, 197, 197] scores;
   [50,432, 1536] hidden rows), fast quotient on and off, 8- and 16-bit
   probs, and at small shapes with a ragged row count and padding columns
   (Shiftmax also at its row tiles' edges: 1 to 1,537 rows, N 1 to 1,024,
   a base a byte off 16-byte alignment, 2- to 16-bit probabilities, x0
   below -2**13, flat rows whose exp sum wraps past 2**31; ShiftGELU: rows held in registers up to 4096, rows read a
   word or a byte a lane); kernel and plain times (Shiftmax: 8-bit with
   either quotient and 16-bit), and the bound;
7. engine: a seeded synthetic DeiT-S ibert engine (224 px, depth 12, batch
   256) through ``Engine``: the launch counts of one forward, its logits
   bitwise equal to the unfused plain engine on the card and, for 4
   images, on the CPU; finite and image-dependent; img/s of both engines;
8. engine_ivit: the same for the synthetic DeiT-S ivit engine on both of
   its kernel paths, the fused block kernels (``Engine(spec)``) and the
   standalone nonlinearity kernels (``Engine(spec, kernels="ops")``), each
   bitwise equal to the plain engine; img/s of all three;
9. swin_attn_block and 10. mlp_block_swin: the Swin window-attention kernel
   and the Swin form of the MLP kernel (int16 rows in and out) bitwise
   equal to their plain versions at the four Swin-T stage shapes of batch
   64 ([4096, 49, 96] to [64, 49, 768] windows; [200,704, 96] to
   [3,136, 768] rows, hidden 4C): shifted and unshifted blocks, every
   family mix, fast flags on and off, ``ln_in``, the int8 input a merge
   feeds a stage, ibert LNs with their overflow shift > 0, and a small
   ragged case; per-stage kernel, plain and library times and the bound;
11. attn_edges: both attention kernels bitwise equal to their plain
   versions at the edge shapes of their 16-row query tiles, 32-key chunks
   and 32-channel head chunks, C 128 with head dims 32, 64 and 128, ivit
   and ibert: ViT token counts 1, 15, 17, 33 and 256 with padding tokens;
   Swin windows of 49 and 64 tokens, shifted and unshifted, int16 and int8
   input; the LN in the kernel and hoisted; softmax scales that take the
   cores' int32 exp and its f32 form;
12. mlp_edges: the MLP kernel bitwise equal to its plain version at the
   widths of every model it serves, C / hidden 96/384, 192/768 and
   384/1536 (its 64-row wgmma block), 768/3072 and 1024/4096 (its 32-row
   block), at row counts 1, 63 and 65, int8 and int16 streams, the LN in
   the kernel and hoisted, every family mix, fast flags on and off; and
   ShiftGELU at GELU scales 1e-3 and 1.0;
13. engine_swin: synthetic Swin-T ivit and ibert engines (224 px, depths
   (2, 2, 6, 2), batch 64) through ``Engine``: 12 + 12 launches a forward,
   logits bitwise equal to the plain engine on the card and, for 4 images,
   on the CPU; finite and image-dependent; img/s of both engines;
14. ppoly_kernels: the ppoly variants of the three block kernels (the
   ppoly GELU in both MLP blocks, the ppoly softmax in both attention
   cores) bitwise equal to their plain versions at DeiT-S shapes (both
   tables of the synthetic DeiT-S ppoly spec, fast-div form and rdiv form,
   padding tokens) and at every Swin-T stage of batch 64 (shifted and
   unshifted; the 32-row MLP block at stage 3); kernel, plain and library
   times and the bound (run before the edge phases);
15. engine_ppoly: the synthetic DeiT-S ppoly engine (ibert LN, batch 256)
   and Swin-T ppoly engine (ivit LN, batch 64), gelu and softmax
   ``ppoly_backend_ibert``, as phases 7 and 13: 12 + 12 launches, logits
   bitwise equal to the plain engine on the card and the CPU, img/s;
16. int16_kernels: the INT16 configuration's variants (bitwidths
   ``8,8,8,8,16,8,16,8``) bitwise equal to their plain versions at DeiT-S
   shapes, ivit, ibert and ppoly, fast flags on and off, the LN in the
   kernel and hoisted: ``attn_block`` at ``sm_bit`` 16 with an int16 output
   (also padded), ``mlp_block`` from int16 rows to int8; their times beside
   the 8-bit variants' and the MLP's Swin form (int16 in and out);
17. int16_edges: the 16-bit attention core at its edges: a one-hot row
   (probability 2**15 - 1), v at -128 and 127 on every channel, flat rows,
   hot padding keys past ``n_valid``; DeiT-S width, C 64 and head dim 128;
18. engine_int16: synthetic DeiT-S INT16 ivit and ibert engines (batch
   256), as phase 7; one DeiT-S float-family forward (batch 4) through the
   fused entry, which runs it unfused as JAX does, within
   ``tests/test_torch_port_float.py``'s bound of the CPU's logits;
19. qat_freeze: the port's QAT sim and its freeze: seeded DeiT-S sims
   (ivit and ibert at full depth, ppoly at depth 2, INT16 ivit at depth 4),
   calibrated on the card and on the CPU from the same state and batches
   (ranges and frozen specs equal leaf for leaf), fitted and frozen; at
   batch 64 the sim's logits bitwise equal to ``Engine(spec)`` on the block
   kernels (depth launches each), to the plain engine and, for ivit, to
   the standalone kernels (INT16 within JAX's bound); live ivit attention,
   image-dependent logits, one backward pass of the full ivit sim; the
   sim's img/s, a calibration step's ms, the freeze's host seconds, the
   engine's img/s on the frozen and the synthetic spec;
20. qat_freeze_swin: the same for seeded Swin-T sims (224 px, depths (2,
   2, 6, 2)), ivit and ibert at full depth, ppoly (``ppoly_backend_ibert``
   GELU and softmax, ivit LN) at depths (2, 2, 2, 2), its GELU fits taking
   seconds a site on the host: card calibration == CPU's
   (ppoly's within 5%: before its fit its softmax runs the golden float
   exp, whose last ulp differs between devices), spec == CPU's, and at batch 64 the sim's logits bitwise equal to ``Engine(spec)``
   on ``swin_attn_block`` + ``mlp_block`` launches, one each a block (12 +
   12 at full depth), and to the plain
   engine; live attention, image-dependent logits, one backward of the full
   ivit sim; sim img/s, a calibration step, the host fit and freeze, engine
   img/s on the frozen beside the synthetic spec;
21. lut: the freeze-time table forms (``IVIT_LUT``) and the integer-sqrt
   ibert LN of the three block kernels: each table form bitwise equal to
   its plain version and to its towers at DeiT-S shapes (ivit, ibert,
   ppoly; 8-bit and INT16; the ivit row sum in one int32 reduction and in
   two limbs) and at the four Swin-T stage shapes (shifted blocks with
   ``sm_sat``), the tables a freeze writes; the integer-sqrt LN in all
   three kernels against their plain versions; times with the tables on
   and off; the frozen specs of phases 19-20 through ``Engine`` with the
   tables on (depth launches of each table form, logits equal to the sims'
   and the towers', the plain engine's table path too) and their img/s on
   and off; synthetic DeiT-S and Swin-T specs with the integer-sqrt LN
   through ``Engine`` (depth launches of its form, logits equal to the
   plain engine's);
22. serving: ``ServingEngine`` (batch 64, max_wait_ms 5, inflight 2) over
   the synthetic DeiT-S ibert spec, 2,048 seeded requests from 4 client
   threads (each with at most 64 outstanding): every answer bitwise equal
   to ``Engine(spec)``'s, 12 + 12 launches a served batch, served img/s
   beside ``Engine`` alone at batch 64, p50 / p95 / p99 latency; the frozen
   Swin-T ivit spec of phase 20 served (256 requests, bitwise); a burst of
   1,024 past ``max_queue`` 128 (rejections counted, every admitted answer
   bitwise) and one past ``deadline_ms`` 20 (sheds counted); under
   ``--profile`` the card's idle share while it serves;
23. train: QAT training (``ivit_tpu_torch.train``) of seeded DeiT-S ivit
   (the qkv gain of phase 19, soft distillation from a seeded bf16 float
   DeiT-S teacher) and Swin-T ibert (drop-path 0.1) at full width and
   depth: calibrated on 2 x 8 images on the card and the CPU (ranges
   equal); one 4-image step on each from the same state (quant_stats
   equal, gradients within 1e-4 of each tensor's largest, params within 2
   * lr); 8 steps of 16 images on one seeded batch (a Mixup step, the last
   two under MultiSteps 2, the EMA after each), the loss finite and
   falling; a checkpoint read into a fresh sim (logits bitwise, state leaf
   for leaf); the trained sim frozen, its logits bitwise equal to
   ``Engine(spec)`` on 12 + 12 block-kernel launches (DeiT-S also on 12 +
   12 standalone ones) and to the plain engine; step ms and img/s, the
   calibration, save, load and freeze seconds;
24. trainer: training from image files through the CLI
   (``ivit_tpu_torch.scripts.quant_train``, in-process): a seeded
   ImageFolder written under ``build/trainer_smoke/`` (10 classes, 80
   train and 40 val images of 160-400 px, PNG and 24-bit BMP, no
   Pillow); the first train batch bitwise equal from 1 and 8 loader
   threads and at the sha256 the CPU test pins through the JAX package's
   Pillow pipeline; DeiT-S ivit at full width and depth (qkv scaled as in
   phase 19), batch 16, RandAugment ``rand-m9-mstd0.5-inc1``, Mixup /
   CutMix, label smoothing, the EMA, one epoch, its calibration equal to
   a CPU Trainer's leaf for leaf; a second epoch resumed from the
   checkpoint (epoch, step, optimizer state and EMA as saved); every
   logged loss finite, JAX's log fields; the trained sim frozen, its
   logits on the first val batch equal to ``Engine(spec)`` on 12 + 12
   block-kernel and 12 + 12 standalone-kernel launches and to the plain
   engine; the loader's img/s with and without RandAugment, each step's
   loader wait share, step ms and img/s, the epoch, calibration,
   validate, save and resume seconds (``--profile``: the card's idle
   share over an epoch);
25. compat_cli: checkpoint interop and the CLIs, in-process, in a
   temporary directory: seeded DeiT-S ibert (qkv scaled as in phase 19)
   and Swin-T ivit sims calibrated on 2 x 8 images, written as reference
   ``.pth.tar`` checkpoints (``compat/export_torch.py``) and loaded into
   fresh sims of another seed (``compat/torch_ckpt.py``): every leaf equal,
   none missing, ``Engine(freeze(...))`` of each 12 + 12 launches with the
   original sim's logits bitwise; the inference CLI
   (``ivit_tpu_torch.scripts.inference``) on the DeiT-S file at batch 256 x
   4, one calibration batch, the artifact and the IO stats written: 12
   launches of each block kernel a forward, the artifact's ``Engine`` equal
   to the sim recalibrated on the same batch, the IO-stats rows the CPU's,
   its img/s; ``engine_inference`` on the artifact (the inference CLI's
   top-1 / top-5 counts) and ``--serve`` at batch 64 x 8 (the counts of
   ``Engine(spec)``'s logits; the server's answers bitwise); ``serving_bench``
   at 256 requests a point (the script's default is 2,048): JAX's keys,
   each overload point adding up; ``analyze_io_stats``' engine audit of
   DeiT-S ibert at batch 4 on the card and the CPU (no hard violation, the
   same records) and the fused DeiT-S ibert engine's img/s with the audit
   taps present and no capture beside phase 7's; ``quant_train
   --pretrained`` with a seeded timm-style float DeiT-S file (the sim's
   parameters the file's; two steps of 16, finite losses); under 90 s;
26. parallel: the dp x tp mesh (``ivit_tpu_torch.parallel``) on the one
   card: a world of one on NCCL in this process (the mesh engine, DeiT-S
   ibert at batch 64 on 12 + 12 fused launches, bitwise ``Engine(spec)``;
   an NCCL int32 all-reduce past 2**24); two gloo ranks on ``cuda:0``
   (spawned: NCCL refuses two ranks on one device): the dp-2 fused engine
   (32 rows and 12 + 12 launches a rank), the tp-2 DeiT-S ivit engine on
   the standalone kernels (3 heads and 768 hidden columns, plus 16 that
   carry the row max, a rank; 12 + 12 launches), each bitwise the
   single-device ``Engine``'s, the tp-2 DeiT-S ivit sim (qkv x 3) bitwise
   the single-device sim, one dp-2 train step on 16 images (ranges
   bitwise; loss and params within ``tests/test_parallel.py``'s bounds);
   three gloo ranks: the Swin-T ivit sim at tp 3 (heads 1/2/4/8 a rank),
   bitwise; the synthetic Swin-T ivit engine at dp 3 on the fused kernels
   (12 + 12 launches a rank) and at tp 3 on the plain path, bitwise the
   single-device ``Engine``'s; ``ServingEngine(devices=["cuda:0", "cuda:0"])``, 512
   requests, every answer bitwise, 24 + 24 launches a served batch, its
   img/s beside a one-replica server's; ``quant_train --mesh-dp 1
   --mesh-tp 1`` (one spawned NCCL rank, one step over a seeded folder)
   and the ``--mesh-dp 2`` refusal on one card; each collective's count
   and ms per forward (host clock, the card synchronized around each:
   gloo's host staging included); under 90 s;
27. scripts: the ports of the JAX package's root scripts
   (``ivit_tpu_torch/scripts/``): ``scaling_bench.measure`` on DeiT-S ibert
   (``build_spec``: qkv x 3 as in phase 19, calibrated on 8 images on the
   card, frozen; 224 px, full depth),
   weak, 32 images a rank, 10 timed forwards, at width 1 (a spawned world
   of one on NCCL) and width 2 (two gloo ranks on ``cuda:0``: the card is
   shared, so the efficiency means nothing), each with its server (a warm
   batch, then twice the batch): every rank's gathered logits and every
   served answer bitwise ``Engine(spec)``'s, 12 + 12 fused launches a rank
   a forward, counted in the rank; the artifact, each rank's seconds and
   ``all_gather`` ms; ``approx_analysis`` (GELU, softmax, exp, LayerNorm of
   ivit, ibert, ppoly and ibert_int_sqrt) on the card and the CPU, outputs
   bitwise and statistics equal; ``ppoly_sweep``'s deg 1-2 x seg 8-16 grid,
   both backends and functions, the card's rows the CPU's; ``sweep
   --dry-run`` on ``sweep.yaml`` (JAX's 8 points in its order, through the
   port's own YAML reader too) and one point trained on the card
   (``quant_train``, DeiT-T ivit, 32 synthetic images at batch 16): return
   code 0 and a final epoch record;
28. dispatch: the engine's path dispatch (``engine/dispatch.py``) held to
   this card's own A/B: ``scripts/path_compare.py`` (modes ``blocks`` and
   ``ops``) on DeiT-T ivit, DeiT-S ivit and ibert and ViT-B ivit (the
   script's spec: the seeded sim calibrated on 8 images and frozen; 224
   px, full depth, batch 256), both modes bitwise one plain forward, 12 +
   12 block-kernel launches a ``blocks`` forward (ivit: 12 + 12
   standalone ones an ``ops`` forward); ``Engine(spec)`` on the
   ``static-table`` row with the ``blocks`` logits, the probe
   (``probe_images``) on DeiT-S ivit and ibert (skipped: no unfused path
   launches a kernel); ``scripts/swin_path_compare.py`` on Swin-T ivit at batch 64
   (fused, attn, mlp, the stage mixes, unfused, the table's mix), every
   mode bitwise, ``Engine(spec)`` on the ``swin-stage-table``; each table
   row's path not slower than the other by more than 10% in this call;
   img/s a mode.

29. ln_requant: the LayerNorm + int8 requant kernel of the LNs outside the
   block kernels bitwise equal to its plain version (the engines' chain)
   at the five Swin-T sites of batch 64 (patch norm [200,704, 96] int8,
   merges [50,176, 384], [12,544, 768] and [3,136, 1,536] int16, the final
   norm [3,136, 768] int16; the spec's leaves, I-LayerNorm, the ibert LN
   and its integer-sqrt form) and DeiT-S's head (the cls rows of a [256,
   197, 384] int8 stream, read in place; the same three LNs); the
   kernel's device time (profiler), a call's time back to back, the plain
   time and the bytes bound at each site (run after the edge phases).
   Every later phase that counts launches counts it too (``ln_norms``):
   one a norm outside the blocks where the engine launches kernels, 5 a
   Swin-T forward and 1 a ViT one (the ``kernels`` line takes the main
   path's, from phases 7 and 13), none on the plain engines.

The build phase reports ptxas's registers and spill bytes per kernel and
fails if any kernel spills.

Then the kernel table as one JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

BATCH, TOKENS = 256, 197
SWIN_BATCH, SWIN_GRID, WIN = 64, 56, 49   # Swin-T: 224 px / patch 4, window 7
H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, H100 SXM data sheet
H100_F32_OPS = 67e12         # float32 outside the tensor cores, same sheet
H100_BYTES = 3.35e12         # HBM3 bandwidth, H100 SXM data sheet
# f32 operations per element of the standalone kernels' arithmetic, counted
# on the plain versions (ops/ivit.py), each add, multiply, divide, floor,
# max or min once, per-row constants left out: the row max and x - max (2),
# int_exp_shift (18: x + floor(x/2) - floor(x/16), the max with n * x0,
# q = floor(x / x0), r = x - x0 * q, r/2 - x0, 2**(n - q), the product, its
# floor and clamp).  Shiftmax adds the row sum (1) and floor(exp * factor *
# 2**-k) (3); ShiftGELU adds exp + exp_max and its clamp (2), the divide
# and floor of the factor (2), the sigmoid (3), x * sigmoid (1) and the
# requant (4: multiply, round, clamp both ways).
SHIFTMAX_F32_OPS = 24
SHIFT_GELU_REQUANT_F32_OPS = 32
# the float family's logits, card against CPU: tests/test_torch_port_float.py's
# bound (torch's f32 exp and erf differ between devices in the last ulp)
FLOAT_LOGIT_TOL = 0.05
IVIT = ("ivit", "ivit", "ivit")                  # (gelu, softmax, ln)
MIXES = [IVIT, ("ivit", "ivit", "ibert"), ("ibert", "ibert", "ivit")]


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


def bound(ops, nbytes, peak=H100_INT8_OPS):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def block_args(torch, blk, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in blk.items()}


def check_equal(torch, name, got, want, rows=None):
    if rows is not None:
        got, want = got[..., :rows, :], want[..., :rows, :]
    err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
    if got.dtype != want.dtype or not torch.equal(got, want):
        bad = (got != want).nonzero()
        raise AssertionError(f"{name}: kernel != plain version at "
                             f"{bad.shape[0]} elements (first {bad[:4].tolist()}), "
                             f"max abs err {err}, dtypes {got.dtype}/{want.dtype}")
    return err


def mix_name(mix):
    return "gelu/softmax/ln " + "/".join(mix)


def mlp_kwargs(b, flags, mix=("ibert", "ibert", "ibert")):
    return dict(ln_bias=b["ln2_bias_int"], m_ln=b["m_ln2"], ln_shift=b["ln2_shift"],
                fc1_w=b["fc1_w"], fc1_b=b["fc1_b"], m_fc1=b["m_fc1"],
                s_gelu=b["s_gelu"], m_gelu=b["m_gelu"], fc2_w=b["fc2_w"],
                fc2_b=b["fc2_b"], m_fc2=b["m_fc2"], m_res_x=b["m_res2_x"],
                m_res_id=b["m_res2_id"], fast_exp=flags, fast_poly=flags,
                gelu_base=mix[0], ln_base=mix[2])


def attn_kwargs(b, flags, heads, n_valid, mix=("ibert", "ibert", "ibert")):
    return dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
                qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
                m_attn=b["m_attn"], s_attn=b["s_attn"], s_exp_act=b.get("s_exp_act"),
                m_av=b["m_av"], proj_w=b["proj_w"], proj_b=b["proj_b"],
                m_proj=b["m_proj"], m_res_x=b["m_res1_x"], m_res_id=b["m_res1_id"],
                num_heads=heads, n_valid=n_valid, fast_exp=flags, fast_poly=flags,
                sm_base=mix[1], ln_base=mix[2])


def kernel_phases(torch, kb, knl, dev):
    """Phases 3-6: each kernel against its plain version; returns the rows
    of the kernel table (launch counts filled in by the engine phases)."""
    import numpy as np

    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec

    rng = np.random.default_rng(0)

    def act(shape, std=32):
        return torch.as_tensor(np.clip(np.round(rng.normal(0, std, shape)), -128,
                                       127).astype(np.int8)).to(dev)

    def uniform(shape):
        return torch.as_tensor(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    def spec_block(mix, **small):
        gelu, softmax, ln = mix
        cfg = deit_small_config(depth=1, img_size=64 if small else 224, ln=ln,
                                gelu=gelu, softmax=softmax)
        cfg = dataclasses.replace(cfg, **small)
        return block_args(torch, synthetic_spec(cfg, 0).params["blocks"][0], dev)

    ibert = ("ibert", "ibert", "ibert")
    tiny = dict(embed_dim=64, num_heads=2, num_classes=10)
    small = {m: spec_block(m, **tiny) for m in [ibert] + MIXES}
    full = {m: spec_block(m) for m in [ibert] + MIXES}
    rows = {}

    # --- mlp_block ---
    x = act((BATCH * TOKENS, 384))
    errs, ms = [], {}
    for mix in [ibert] + MIXES:
        for flags in (True, False):
            xs = act((2 * 24, 64))
            check_equal(torch, f"mlp_block small {mix_name(mix)} fast={flags}",
                        kb.mlp_block(xs, **mlp_kwargs(small[mix], flags, mix)),
                        kb.mlp_block_ref(xs, **mlp_kwargs(small[mix], flags, mix)))
            kw = mlp_kwargs(full[mix], flags, mix)
            got = kb.mlp_block(x, **kw)
            torch.cuda.synchronize()
            errs.append(check_equal(torch, f"mlp_block {mix_name(mix)} fast={flags}",
                                    got, kb.mlp_block_ref(x, **kw)))
    kw = mlp_kwargs(full[IVIT], True, IVIT)
    kw["ln_in"] = kb._ln8(x, "ivit", kw["ln_bias"], kw["ln_shift"], kw["m_ln"], None)
    errs.append(check_equal(torch, "mlp_block ivit ln_in", kb.mlp_block(x, **kw),
                            kb.mlp_block_ref(x, **kw)))
    for name, mix in (("ibert", ibert), ("ivit", IVIT)):
        kw = mlp_kwargs(full[mix], True, mix)
        ms[name] = time_ms(torch, lambda: kb.mlp_block(x, **kw), iters=20)
    kw = mlp_kwargs(full[IVIT], True, IVIT)
    plain_ms = time_ms(torch, lambda: kb.mlp_block_ref(x, **kw), iters=3, warmup=1)
    blk = full[IVIT]
    h = torch.empty((x.shape[0], blk["fc1_w"].shape[1]), dtype=torch.int8, device=dev)
    lib_ms = time_ms(torch, lambda: (torch._int_mm(x, blk["fc1_w"]),
                                     torch._int_mm(h, blk["fc2_w"])), iters=20)
    r, c, hd = x.shape[0], 384, blk["fc1_w"].shape[1]
    ops = 2 * r * c * hd * 2
    nb = nbytes(x, x, blk["fc1_w"], blk["fc2_w"], blk["fc1_b"], blk["fc2_b"],
                blk["m_fc1"], blk["m_fc2"], blk["m_ln2"], blk["ln2_bias_int"])
    b_ms, b_by = bound(ops, nb)
    rows["mlp_block"] = dict(
        name="mlp_block", route="cuda", source="ivit_tpu_torch/csrc/mlp_block.cu",
        replaces="ivit_tpu/ops/pallas/block.py:783", launches=None,
        max_abs_err=max(errs), ms=ms["ivit"], plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ms_by_family=ms)
    emit({"phase": "mlp_block", "equal": True, "shape": [r, c, hd],
          "families_checked": [mix_name(m) for m in [ibert] + MIXES] + ["ivit ln_in"],
          "kernel_ms_ivit": ms["ivit"], "kernel_ms_ibert": ms["ibert"],
          "plain_ms_ivit": plain_ms, "library_ms": lib_ms,
          "library": "torch._int_mm fc1 + fc2", "bound_ms": b_ms,
          "bound_by": b_by, "int8_ops": ops, "bytes": nb, "max_abs_err": max(errs)})

    # --- attn_block ---
    x = act((BATCH, TOKENS, 384))
    errs, ms = [], {}
    for mix in [ibert] + MIXES:
        for flags in (True, False):
            xs = act((2, 24, 64))
            check_equal(torch, f"attn_block small padded {mix_name(mix)} fast={flags}",
                        kb.attn_block(xs, **attn_kwargs(small[mix], flags, 2, 17, mix)),
                        kb.attn_block_ref(xs, **attn_kwargs(small[mix], flags, 2, 17, mix)),
                        rows=17)
            kw = attn_kwargs(full[mix], flags, 6, TOKENS, mix)
            got = kb.attn_block(x, **kw)
            torch.cuda.synchronize()
            errs.append(check_equal(torch, f"attn_block {mix_name(mix)} fast={flags}",
                                    got, kb.attn_block_ref(x, **kw)))
    kw = attn_kwargs(full[IVIT], True, 6, TOKENS, IVIT)
    kw["ln_in"] = kb._ln8(x, "ivit", kw["ln_bias"], kw["ln_shift"], kw["m_ln"], None)
    errs.append(check_equal(torch, "attn_block ivit ln_in", kb.attn_block(x, **kw),
                            kb.attn_block_ref(x, **kw)))
    for name, mix in (("ibert", ibert), ("ivit", IVIT)):
        kw = attn_kwargs(full[mix], True, 6, TOKENS, mix)
        ms[name] = time_ms(torch, lambda: kb.attn_block(x, **kw), iters=20)
    kw = attn_kwargs(full[IVIT], True, 6, TOKENS, IVIT)
    plain_ms = time_ms(torch, lambda: kb.attn_block_ref(x, **kw), iters=3, warmup=1)
    blk = full[IVIT]
    x2 = x.reshape(-1, 384)
    lib_ms = time_ms(torch, lambda: (torch._int_mm(x2, blk["qkv_w"]),
                                     torch._int_mm(x2, blk["proj_w"])), iters=20)
    r, c = x2.shape
    ops = 2 * r * (3 * c * c + c * c) + 2 * 2 * BATCH * TOKENS * TOKENS * c
    nb = nbytes(x, x, blk["qkv_w"], blk["proj_w"], blk["qkv_b"],
                blk["proj_b"], blk["m_qkv"], blk["m_proj"], blk["m_ln1"],
                blk["ln1_bias_int"])
    b_ms, b_by = bound(ops, nb)
    rows["attn_block"] = dict(
        name="attn_block", route="cuda", source="ivit_tpu_torch/csrc/attn_block.cu",
        replaces="ivit_tpu/ops/pallas/block.py:1112", launches=None,
        max_abs_err=max(errs), ms=ms["ivit"], plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ms_by_family=ms)
    emit({"phase": "attn_block", "equal": True, "shape": [BATCH, TOKENS, c, 6],
          "families_checked": [mix_name(m) for m in [ibert] + MIXES] + ["ivit ln_in"],
          "kernel_ms_ivit": ms["ivit"], "kernel_ms_ibert": ms["ibert"],
          "plain_ms_ivit": plain_ms, "library_ms": lib_ms,
          "library": "torch._int_mm qkv + proj", "bound_ms": b_ms,
          "bound_by": b_by, "int8_ops": ops, "bytes": nb, "max_abs_err": max(errs)})

    # --- shiftmax ---  (no single PyTorch call computes Shiftmax)
    s_attn = full[IVIT]["s_attn"]
    scores = uniform((BATCH, 6, TOKENS, TOKENS))
    errs = []
    for shape, n_valid in (((130, 50), None), ((3, 5, 24), 17), ((3, 700), 650)):
        xs = uniform(shape)
        for bit in (8, 16):
            for fq in (True, False):
                errs.append(check_equal(
                    torch, f"shiftmax small {shape} n_valid={n_valid} bits={bit} fast_q={fq}",
                    knl.shiftmax(xs, s_attn, bit, n_valid=n_valid, fast_q=fq),
                    knl.shiftmax_ref(xs, s_attn, bit, n_valid=n_valid, fast_q=fq)))
    # the row tiles' edges: row counts off the 32- and 16-row tiles, widths
    # about the 224-column split and 256, a base a byte past 16-byte
    # alignment (the byte path), n_valid 1 and N - 1, 2- to 16-bit
    # probabilities, x0 past -2**13 (s 1e-4)
    s_small = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    for shape, n_valid in (((1, TOKENS), None), ((15, TOKENS), TOKENS - 1),
                           ((1537, TOKENS), 1), ((17, 224), 223), ((17, 225), None),
                           ((17, 256), 255), ((17, 257), None),
                           ((1537, 1024), 1023), ((33, 1), None)):
        xs = torch.as_tensor(rng.integers(-128, 128, shape).astype(np.int8)).to(dev)
        for offset in (0, 1):
            buf = torch.empty(xs.numel() + 16, dtype=torch.int8, device=dev)
            xo = buf[offset:offset + xs.numel()].view(shape)
            xo.copy_(xs)
            for bit, sa, fq in ((2, s_attn, True), (8, s_small, False),
                                (15, s_attn, False), (16, s_small, True)):
                errs.append(check_equal(
                    torch, f"shiftmax edge {shape} n_valid={n_valid} offset={offset} "
                    f"bits={bit} s={sa.item()} fast_q={fq}",
                    knl.shiftmax(xo, sa, bit, n_valid=n_valid, fast_q=fq),
                    knl.shiftmax_ref(xs, sa, bit, n_valid=n_valid, fast_q=fq)))
    # flat rows whose exps sum past 2**31: the high limbs' int32 sum wraps,
    # as in the reference, and the probabilities come out negative
    for shape, s in (((3, 700), 3e-5), ((17, 1024), 5e-5)):
        xs = torch.full(shape, 5, dtype=torch.int8, device=dev)
        sa = torch.tensor(s, dtype=torch.float32, device=dev)
        for offset in (0, 1):
            buf = torch.empty(xs.numel() + 16, dtype=torch.int8, device=dev)
            xo = buf[offset:offset + xs.numel()].view(shape)
            xo.copy_(xs)
            for bit in (8, 16):
                for fq in (True, False):
                    want = knl.shiftmax_ref(xs, sa, bit, fast_q=fq)
                    if not (want < 0).all():
                        raise AssertionError(f"shiftmax wrap {shape}: no wrapped row sum")
                    errs.append(check_equal(
                        torch, f"shiftmax wrap {shape} offset={offset} bits={bit} "
                        f"s={s} fast_q={fq}", knl.shiftmax(xo, sa, bit, fast_q=fq), want))
    for bit in (8, 16):
        for fq in (True, False):
            got = knl.shiftmax(scores, s_attn, bit, fast_q=fq)
            torch.cuda.synchronize()
            errs.append(check_equal(torch, f"shiftmax bits={bit} fast_q={fq}", got,
                                    knl.shiftmax_ref(scores, s_attn, bit, fast_q=fq)))
    got = knl.shiftmax(scores, s_attn, 8, n_valid=180, fast_q=True)
    errs.append(check_equal(torch, "shiftmax n_valid=180", got,
                            knl.shiftmax_ref(scores, s_attn, 8, n_valid=180, fast_q=True)))
    if not (got[..., :180] > 0).any() or (got[..., 180:] != 0).any():
        raise AssertionError("shiftmax: no live probabilities, or live padding")
    ms = {f"{bit}bit_fast_q={fq}": time_ms(
        torch, lambda: knl.shiftmax(scores, s_attn, bit, fast_q=fq), iters=20)
        for bit, fq in ((8, True), (8, False), (16, True))}
    plain_ms = time_ms(torch, lambda: knl.shiftmax_ref(scores, s_attn, 8, fast_q=True),
                       iters=3, warmup=1)
    nb, f32_ops = nbytes(scores, got), SHIFTMAX_F32_OPS * scores.numel()
    b_ms, b_by = bound(f32_ops, nb, H100_F32_OPS)
    b16_ms, _ = bound(f32_ops, 3 * nbytes(scores), H100_F32_OPS)  # int16 out
    rows["shiftmax"] = dict(
        name="shiftmax", route="cuda", source="ivit_tpu_torch/csrc/nonlinear.cu",
        replaces="ivit_tpu/ops/pallas/nonlinear.py:135", launches=None,
        max_abs_err=max(errs), ms=ms["8bit_fast_q=True"], plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, ms_by_variant=ms,
        bound_ms_16bit=b16_ms)
    emit({"phase": "shiftmax", "equal": True, "shape": list(scores.shape),
          "s_attn": s_attn.item(), "kernel_ms": ms, "plain_ms": plain_ms,
          "library_ms": None, "bound_ms": b_ms, "bound_ms_16bit": b16_ms,
          "bound_by": b_by, "bytes": nb, "f32_ops": f32_ops,
          "live_prob_share": (got > 0).float().mean().item(), "checks": len(errs),
          "max_abs_err": max(errs)})

    # --- shift_gelu_requant ---
    blk = full[IVIT]
    h = act((BATCH * TOKENS, 1536))
    errs = []
    for shape in ((130, 1536), (5, 30), (3, 7, 384), (9, 2048), (3, 4096),
                  (3, 4112), (7, 100)):
        xs = act(shape)
        for fq in (True, False):
            errs.append(check_equal(
                torch, f"shift_gelu_requant small {shape} fast_q={fq}",
                knl.shift_gelu_requant(xs, blk["s_gelu"], blk["m_gelu"], fast_q=fq),
                knl.shift_gelu_requant_ref(xs, blk["s_gelu"], blk["m_gelu"], fast_q=fq)))
    for fq in (True, False):
        got = knl.shift_gelu_requant(h, blk["s_gelu"], blk["m_gelu"], fast_q=fq)
        torch.cuda.synchronize()
        errs.append(check_equal(
            torch, f"shift_gelu_requant fast_q={fq}", got,
            knl.shift_gelu_requant_ref(h, blk["s_gelu"], blk["m_gelu"], fast_q=fq)))
    ms = time_ms(torch, lambda: knl.shift_gelu_requant(
        h, blk["s_gelu"], blk["m_gelu"], fast_q=True), iters=20)
    plain_ms = time_ms(torch, lambda: knl.shift_gelu_requant_ref(
        h, blk["s_gelu"], blk["m_gelu"], fast_q=True), iters=3, warmup=1)
    nb, f32_ops = nbytes(h, got), SHIFT_GELU_REQUANT_F32_OPS * h.numel()
    b_ms, b_by = bound(f32_ops, nb, H100_F32_OPS)
    rows["shift_gelu_requant"] = dict(
        name="shift_gelu_requant", route="cuda",
        source="ivit_tpu_torch/csrc/nonlinear.cu",
        replaces="ivit_tpu/ops/pallas/nonlinear.py:192", launches=None,
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    emit({"phase": "shift_gelu_requant", "equal": True, "shape": list(h.shape),
          "s_gelu": blk["s_gelu"].item(), "kernel_ms": ms, "plain_ms": plain_ms,
          "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bytes": nb,
          "f32_ops": f32_ops, "nonzero_share": (got != 0).float().mean().item(),
          "max_abs_err": max(errs)})
    return rows


EDGE_TOKENS = [(1, 1), (15, 13), (17, 15), (33, 31), (256, 250)]   # (Np, n_valid)
EDGE_HEADS = [4, 2, 1]    # C 128: head dims 32, 64, 128


def attn_edge_phase(torch, kb, dev):
    """Phase 11: both attention kernels at the edge shapes of their tiles."""
    import numpy as np

    from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                                  synthetic_spec, synthetic_swin_spec)

    rng = np.random.default_rng(2)

    def stream(shape, bits):
        lim = 2 ** (bits - 1)
        x = np.clip(np.round(rng.normal(0, lim / 4, shape)), -lim, lim - 1)
        return torch.as_tensor(x.astype(np.int16 if bits > 8 else np.int8)).to(dev)

    checked = 0
    for fam in ("ivit", "ibert"):
        mix = (fam, fam, fam)
        for heads in EDGE_HEADS:
            cfg = dataclasses.replace(
                deit_small_config(depth=1, img_size=64, ln=fam, gelu=fam, softmax=fam),
                embed_dim=128, num_heads=heads, num_classes=10)
            b = block_args(torch, synthetic_spec(cfg, 5).params["blocks"][0], dev)
            for np_, nv in EDGE_TOKENS:
                x = stream((2, np_, 128), 8)
                kw = attn_kwargs(b, True, heads, nv, mix)
                for ln_in in (None, kb._ln8(x, fam, kw["ln_bias"], kw["ln_shift"],
                                            kw["m_ln"], None)):
                    check_equal(torch, f"attn_block edge {fam} Np={np_} n_valid={nv} "
                                f"dh={128 // heads} ln_in={ln_in is not None}",
                                kb.attn_block(x, ln_in=ln_in, **kw),
                                kb.attn_block_ref(x, ln_in=ln_in, **kw), rows=nv)
                    checked += 1
            for ws in (7, 8):
                spec = synthetic_swin_spec(swin_tiny_config(
                    depths=(2,), img_size=8 * ws, embed_dim=128, stage_heads=(heads,),
                    window_size=ws, num_classes=10, gelu=fam, softmax=fam, ln=fam), seed=5)
                for (_, _, shift), blk in zip(spec.config.layout, spec.params["blocks"]):
                    b = block_args(torch, blk, dev)
                    kw = swin_attn_kwargs(b, True, heads, 4, shift, mix)
                    for bits in (16, 8):
                        x = stream((8, ws * ws, 128), bits)
                        for ln_in in (None, kb._ln8(x, fam, kw["ln_bias"], kw["ln_shift"],
                                                    kw["m_ln"], None)):
                            check_equal(torch, f"swin_attn_block edge {fam} n={ws * ws} "
                                        f"dh={128 // heads} shift={shift} bits={bits} "
                                        f"ln_in={ln_in is not None}",
                                        kb.swin_attn_block(x, ln_in=ln_in, **kw),
                                        kb.swin_attn_block_ref(x, ln_in=ln_in, **kw))
                            checked += 1
    # softmax scales that take the cores' int32 exp and its f32 form
    for fam in ("ivit", "ibert"):
        mix = (fam, fam, fam)
        cfg = dataclasses.replace(
            deit_small_config(depth=1, img_size=64, ln=fam, gelu=fam, softmax=fam),
            embed_dim=64, num_heads=2, num_classes=10)
        b = block_args(torch, synthetic_spec(cfg, 0).params["blocks"][0], dev)
        x = stream((2, 24, 64), 8)
        for s_attn in (2.0, 0.0521371, 1e-4):
            kw = attn_kwargs(b, True, 2, 17, mix) | dict(
                s_attn=torch.tensor(s_attn, device=dev))
            check_equal(torch, f"attn_block {fam} s_attn={s_attn}",
                        kb.attn_block(x, **kw), kb.attn_block_ref(x, **kw), rows=17)
            checked += 1
    emit({"phase": "attn_edges", "equal": True, "checks": checked,
          "vit_tokens_n_valid": EDGE_TOKENS, "swin_window_tokens": [49, 64],
          "head_dims": [128 // h for h in EDGE_HEADS], "C": 128})


MLP_EDGE_WIDTHS = [(96, 384), (192, 768), (384, 1536), (768, 3072), (1024, 4096)]
MLP_EDGE_ROWS = (1, 63, 65)


def mlp_edge_phase(torch, kb, knl, dev):
    """Phase 12: the MLP kernel at the widths of every model it serves,
    ragged rows, both streams; ShiftGELU at far GELU scales."""
    import numpy as np

    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec

    rng = np.random.default_rng(3)

    def stream(shape, bits):
        lim = 2 ** (bits - 1)
        x = np.clip(np.round(rng.normal(0, lim / 4, shape)), -lim, lim - 1)
        return torch.as_tensor(x.astype(np.int16 if bits > 8 else np.int8)).to(dev)

    checked = 0
    for c, hd in MLP_EDGE_WIDTHS:
        for mix in [("ibert", "ibert", "ibert")] + MIXES:
            gelu, softmax, ln = mix
            cfg = dataclasses.replace(
                deit_small_config(depth=1, img_size=64, ln=ln, gelu=gelu, softmax=softmax),
                embed_dim=c, num_heads=c // 32, num_classes=10)
            b = block_args(torch, synthetic_spec(cfg, 7).params["blocks"][0], dev)
            assert tuple(b["fc1_w"].shape) == (c, hd)
            for r in MLP_EDGE_ROWS:
                for bits in (8, 16):
                    x = stream((r, c), bits)
                    for flags in (True, False):
                        kw = mlp_kwargs(b, flags, mix) | dict(mlp_bits=8, out_bits=bits)
                        for ln_in in (None, kb._ln8(x, ln, kw["ln_bias"], kw["ln_shift"],
                                                    kw["m_ln"], None)):
                            check_equal(torch, f"mlp_block edge C={c} hidden={hd} R={r} "
                                        f"bits={bits} {mix_name(mix)} fast={flags} "
                                        f"ln_in={ln_in is not None}",
                                        kb.mlp_block(x, ln_in=ln_in, **kw),
                                        kb.mlp_block_ref(x, ln_in=ln_in, **kw))
                            checked += 1
            if mix == IVIT:
                x = stream((65, c), 8)
                for s_gelu in (1e-3, 1.0):
                    s_t = torch.tensor(s_gelu, device=dev)
                    kw = mlp_kwargs(b, True, mix) | dict(s_gelu=s_t)
                    check_equal(torch, f"mlp_block edge C={c} s_gelu={s_gelu}",
                                kb.mlp_block(x, **kw), kb.mlp_block_ref(x, **kw))
                    h = stream((33, hd), 8)
                    check_equal(torch, f"shift_gelu_requant H={hd} s_gelu={s_gelu}",
                                knl.shift_gelu_requant(h, s_t, b["m_gelu"]),
                                knl.shift_gelu_requant_ref(h, s_t, b["m_gelu"]))
                    checked += 2
    emit({"phase": "mlp_edges", "equal": True, "checks": checked,
          "widths": MLP_EDGE_WIDTHS, "rows": list(MLP_EDGE_ROWS),
          "streams_bits": [8, 16], "far_s_gelu": [1e-3, 1.0]})


LN_FAMS = [("ivit", False), ("ibert", False), ("ibert", True)]   # (LN, int sqrt)


def ln_requant_phase(torch, knl, dev, rows):
    """Phase 29: the LN + requant kernel at the Swin-T sites of batch 64 and
    DeiT-S's head at batch 256, against its plain version, timed beside its
    bound.  Its launches a forward are the engine phases' (``ln_norms``)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                                  synthetic_spec, synthetic_swin_spec)

    rng = np.random.default_rng(11)

    def stream(shape, dtype):
        info = torch.iinfo(dtype)
        std = 40 if dtype == torch.int8 else 6000
        x = np.clip(np.round(rng.normal(0, std, shape)), info.min, info.max)
        return torch.as_tensor(x).to(dtype).to(dev)

    swin = synthetic_swin_spec(swin_tiny_config(), seed=0)
    deit = synthetic_spec(deit_small_config(), seed=0)
    p = swin.params
    merges = [blk["merge"] for blk in p["blocks"] if "merge" in blk]
    g = SWIN_GRID
    # (site, x, bias, m, shift): the leaves as the specs hold them
    sites = [("swin_patch_norm", stream((SWIN_BATCH * g * g, 96), torch.int8),
              p["patch"]["pn_bias_int"], p["patch"]["m_norm"], p["patch"]["pn_shift"])]
    for i, mg in enumerate(merges):
        n = g // 2 ** (i + 1)
        sites.append((f"swin_merge{i}", stream((SWIN_BATCH * n * n, 4 * 96 * 2**i), torch.int16),
                      mg["norm_bias_int"], mg["m_norm"], mg["norm_shift"]))
    sites.append(("swin_final_norm", stream((SWIN_BATCH * 49, 768), torch.int16),
                  p["lnf_bias_int"], p["m_lnf"], p["lnf_shift"]))
    sites.append(("deit_head", stream((BATCH, TOKENS, 384), torch.int8)[:, :1],
                  deit.params["lnf_bias_int"], deit.params["m_lnf"],
                  deit.params["lnf_shift"]))
    out, checks = {}, 0
    for name, x, bias, m, shift in sites:
        leaves = [torch.as_tensor(np.asarray(v, np.float32)).to(dev) for v in (bias, m, shift)]
        for ln, isqrt in LN_FAMS:
            kw = dict(ln_base=ln, use_int_sqrt=isqrt)
            check_equal(torch, f"ln_requant {name} {ln} int_sqrt={isqrt}",
                        knl.ln_requant(x, *leaves, **kw), knl.ln_requant_ref(x, *leaves, **kw))
            checks += 1
        # the family the benchmark's configs run at each site; the kernel's
        # device time from the profiler (back to back, a call of these small
        # launches is paced by the wrapper's host time: call_ms)
        kw = dict(ln_base="ibert" if name == "deit_head" else "ivit")
        call_ms = time_ms(torch, lambda: knl.ln_requant(x, *leaves, **kw), iters=20)
        plain_ms = time_ms(torch, lambda: knl.ln_requant_ref(x, *leaves, **kw),
                           iters=3, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                knl.ln_requant(x, *leaves, **kw)
            torch.cuda.synchronize()
        ms = sum(a.self_device_time_total for a in prof.key_averages()
                 if a.device_type == DeviceType.CUDA and "ln_requant_kernel" in a.key) / 1e4
        nb = x.numel() * (x.element_size() + 1) + 2 * 4 * x.shape[-1]
        out[name] = {"shape": list(x.shape), "dtype": str(x.dtype), "ln": kw["ln_base"],
                     "kernel_ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                     "bytes": nb, "bound_ms": nb / H100_BYTES * 1e3}
    swin_sites = [v for k, v in out.items() if k.startswith("swin")]
    rows["ln_requant"] = dict(
        name="ln_requant", route="cuda", source="ivit_tpu_torch/csrc/nonlinear.cu",
        replaces=None, launches={}, max_abs_err=0,
        ms=sum(v["kernel_ms"] for v in swin_sites),
        plain_ms=sum(v["plain_ms"] for v in swin_sites),
        bound_ms=sum(v["bound_ms"] for v in swin_sites), bound_by="bytes",
        library_ms=None, ms_by_site={k: v["kernel_ms"] for k, v in out.items()})
    emit({"phase": "ln_requant", "equal": True, "checks": checks, "sites": out,
          "swin_t_batch_ms": rows["ln_requant"]["ms"],
          "swin_t_batch_bound_ms": rows["ln_requant"]["bound_ms"],
          "swin_t_batch_plain_ms": rows["ln_requant"]["plain_ms"]})


PPOLY = "ppoly_backend_ibert"


def ppoly_gelu_kwargs(b, fastdiv):
    return dict(gelu_bounds=b["gelu_bounds"], gelu_coeffs=b["gelu_coeffs"],
                gelu_s_out=b["gelu_s_out"], gelu_fastdiv=fastdiv,
                gelu_s_out_c=b["gelu_s_out_c"], gelu_patch_h=b["gelu_patch_h"],
                gelu_patch_d=b["gelu_patch_d"])


def ppoly_sm_kwargs(b):
    return dict(sm_bounds=b["sm_bounds"], sm_coeffs=b["sm_coeffs"], exp_bits=16)


def ppoly_row(name, source, replaces, errs, per, plain_ms, lib_ms, ops, nb):
    b_ms, b_by = bound(ops, nb)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=max(errs), ms=per, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def ppoly_phases(torch, kb, dev, rows):
    """Phase 14: the ppoly variants of the three block kernels against their
    plain versions: DeiT-S shapes (both blocks of the ppoly spec's tables,
    fast-div on and off, padding tokens), every Swin-T stage (shifted and
    unshifted; the 32-row MLP block at stage 3); adds the three ppoly rows
    (times: the fast-div form the engines take)."""
    import numpy as np

    from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                                  synthetic_spec, synthetic_swin_spec)

    rng = np.random.default_rng(4)

    def stream(shape, bits):
        lim = 2 ** (bits - 1)
        x = np.clip(np.round(rng.normal(0, lim / 4, shape)), -lim, lim - 1)
        return torch.as_tensor(x.astype(np.int16 if bits > 8 else np.int8)).to(dev)

    mix = (PPOLY, PPOLY, "ibert")
    spec = synthetic_spec(deit_small_config(depth=2, ln="ibert", gelu=PPOLY,
                                            softmax=PPOLY), seed=0)
    blocks = [block_args(torch, b, dev) for b in spec.params["blocks"]]
    if not spec.config.ppoly_fastdiv:
        raise AssertionError("the DeiT-S ppoly spec failed its fast-div gate")
    x = stream((BATCH * TOKENS, 384), 8)
    xa = stream((BATCH, TOKENS, 384), 8)
    xs = stream((2, 24, 384), 8)
    errs_m, errs_a = [], []
    for i, b in enumerate(blocks):
        for fastdiv in (True, False):
            kw = mlp_kwargs(b, True, ("ppoly", "ppoly", "ibert")) | ppoly_gelu_kwargs(b, fastdiv)
            got = kb.mlp_block(x, **kw)
            torch.cuda.synchronize()
            errs_m.append(check_equal(torch, f"mlp_block ppoly block {i} fastdiv={fastdiv}",
                                      got, kb.mlp_block_ref(x, **kw)))
        kw = attn_kwargs(b, True, 6, TOKENS, ("ppoly", "ppoly", "ibert")) | ppoly_sm_kwargs(b)
        got = kb.attn_block(xa, **kw)
        torch.cuda.synchronize()
        errs_a.append(check_equal(torch, f"attn_block ppoly block {i}", got,
                                  kb.attn_block_ref(xa, **kw)))
        kw = kw | dict(n_valid=17)
        errs_a.append(check_equal(torch, f"attn_block ppoly block {i} padded",
                                  kb.attn_block(xs, **kw), kb.attn_block_ref(xs, **kw),
                                  rows=17))
    b = blocks[0]
    kw_m = mlp_kwargs(b, True, ("ppoly", "ppoly", "ibert")) | ppoly_gelu_kwargs(b, True)
    kw_a = attn_kwargs(b, True, 6, TOKENS, ("ppoly", "ppoly", "ibert")) | ppoly_sm_kwargs(b)
    deit = dict(
        mlp_ms=time_ms(torch, lambda: kb.mlp_block(x, **kw_m), iters=20),
        mlp_ms_rdiv=time_ms(torch, lambda: kb.mlp_block(
            x, **(kw_m | dict(gelu_fastdiv=False))), iters=20),
        mlp_plain_ms=time_ms(torch, lambda: kb.mlp_block_ref(x, **kw_m), iters=3, warmup=1),
        attn_ms=time_ms(torch, lambda: kb.attn_block(xa, **kw_a), iters=20),
        attn_plain_ms=time_ms(torch, lambda: kb.attn_block_ref(xa, **kw_a), iters=3,
                              warmup=1))
    xa2 = xa.reshape(-1, 384)
    h = torch.empty((x.shape[0], 1536), dtype=torch.int8, device=dev)
    deit["mlp_library_ms"] = time_ms(torch, lambda: (torch._int_mm(x, b["fc1_w"]),
                                                      torch._int_mm(h, b["fc2_w"])), iters=20)
    deit["attn_library_ms"] = time_ms(torch, lambda: (torch._int_mm(xa2, b["qkv_w"]),
                                                       torch._int_mm(xa2, b["proj_w"])), iters=20)
    r = x.shape[0]
    mlp_ops = 2 * r * 384 * 1536 * 2
    mlp_nb = nbytes(x, x, b["fc1_w"], b["fc2_w"], b["fc1_b"], b["fc2_b"], b["m_fc1"],
                    b["m_fc2"], b["m_ln2"], b["ln2_bias_int"], b["gelu_bounds"],
                    b["gelu_coeffs"])
    attn_ops = 2 * r * (4 * 384 * 384) + 2 * 2 * BATCH * TOKENS * TOKENS * 384
    attn_nb = nbytes(xa, xa, b["qkv_w"], b["proj_w"], b["qkv_b"], b["proj_b"],
                     b["m_qkv"], b["m_proj"], b["m_ln1"], b["ln1_bias_int"],
                     b["sm_bounds"], b["sm_coeffs"])

    # --- Swin-T stages ---
    sspec = synthetic_swin_spec(swin_tiny_config(ln="ivit", gelu=PPOLY, softmax=PPOLY),
                                seed=0)
    if not sspec.config.ppoly_fastdiv:
        raise AssertionError("the Swin-T ppoly spec failed its fast-div gate")
    swin = []
    errs_s, errs_ms = [], []
    for st, (c, heads, nw, blks) in enumerate(swin_stage_blocks(torch, sspec, dev)):
        x16 = stream((SWIN_BATCH * nw, WIN, c), 16)
        for shift, sb in blks:
            kw = swin_attn_kwargs(sb, True, heads, nw, shift,
                                  ("ppoly", "ppoly", "ivit")) | ppoly_sm_kwargs(sb)
            got = kb.swin_attn_block(x16, **kw)
            torch.cuda.synchronize()
            errs_s.append(check_equal(torch, f"swin_attn_block ppoly stage {st} shift {shift}",
                                      got, kb.swin_attn_block_ref(x16, **kw)))
        xr = x16.reshape(-1, c)
        sb = blks[0][1]
        for fastdiv in (True, False):
            kw = mlp_kwargs(sb, True, ("ppoly", "ppoly", "ivit")) | dict(
                mlp_bits=8, out_bits=16) | ppoly_gelu_kwargs(sb, fastdiv)
            got = kb.mlp_block(xr, **kw)
            torch.cuda.synchronize()
            errs_ms.append(check_equal(torch, f"mlp_block swin ppoly stage {st} "
                                       f"fastdiv={fastdiv}", got, kb.mlp_block_ref(xr, **kw)))
        shift, sb = blks[-1]
        kw_s = swin_attn_kwargs(sb, True, heads, nw, shift,
                                ("ppoly", "ppoly", "ivit")) | ppoly_sm_kwargs(sb)
        kw_m = mlp_kwargs(blks[0][1], True, ("ppoly", "ppoly", "ivit")) | dict(
            mlp_bits=8, out_bits=16) | ppoly_gelu_kwargs(blks[0][1], True)
        x2 = torch.clamp(x16, -128, 127).to(torch.int8).reshape(-1, c)
        hs = torch.empty((x2.shape[0], 4 * c), dtype=torch.int8, device=dev)
        rs = x2.shape[0]
        swin.append(dict(
            stage=st, shift=shift, attn_ms=time_ms(torch, lambda: kb.swin_attn_block(x16, **kw_s), iters=20),
            attn_plain_ms=time_ms(torch, lambda: kb.swin_attn_block_ref(x16, **kw_s), iters=2, warmup=1),
            attn_library_ms=time_ms(torch, lambda: (torch._int_mm(x2, sb["qkv_w"]),
                                                    torch._int_mm(x2, sb["proj_w"])), iters=20),
            attn_bound=bound(2 * rs * 4 * c * c + 2 * 2 * rs * WIN * c,
                             nbytes(x16, x16, sb["qkv_w"], sb["proj_w"], sb["qkv_b"],
                                    sb["proj_b"], sb["m_qkv"], sb["m_proj"], sb["m_ln1"],
                                    sb["ln1_bias_int"], sb["rel_bias_addend"],
                                    sb["sm_bounds"], sb["sm_coeffs"],
                                    *([sb["mask_int"]] if shift else []))),
            mlp_ms=time_ms(torch, lambda: kb.mlp_block(xr, **kw_m), iters=20),
            mlp_plain_ms=time_ms(torch, lambda: kb.mlp_block_ref(xr, **kw_m), iters=2, warmup=1),
            mlp_library_ms=time_ms(torch, lambda: (torch._int_mm(x2, blks[0][1]["fc1_w"]),
                                                   torch._int_mm(hs, blks[0][1]["fc2_w"])),
                                   iters=20),
            mlp_bound=bound(2 * rs * c * 4 * c * 2,
                            nbytes(x16, x16, blks[0][1]["fc1_w"], blks[0][1]["fc2_w"]))))
    rows["mlp_block[ppoly]"] = ppoly_row(
        "mlp_block[ppoly]", "ivit_tpu_torch/csrc/mlp_block.cu",
        "ivit_tpu/ops/pallas/block.py:783", errs_m + errs_ms, deit["mlp_ms"],
        deit["mlp_plain_ms"], deit["mlp_library_ms"], mlp_ops, mlp_nb)
    rows["mlp_block[ppoly]"].update(
        ms_rdiv_form=deit["mlp_ms_rdiv"], swin_ms_by_stage=[d["mlp_ms"] for d in swin],
        times_are="DeiT-S [50,432, 384], hidden 1536, fast-div form")
    rows["attn_block[ppoly]"] = ppoly_row(
        "attn_block[ppoly]", "ivit_tpu_torch/csrc/attn_block.cu",
        "ivit_tpu/ops/pallas/block.py:1112", errs_a, deit["attn_ms"],
        deit["attn_plain_ms"], deit["attn_library_ms"], attn_ops, attn_nb)
    rows["swin_attn_block[ppoly]"] = dict(
        name="swin_attn_block[ppoly]", route="cuda",
        source="ivit_tpu_torch/csrc/swin_attn_block.cu",
        replaces="ivit_tpu/ops/pallas/block.py:1373", launches=None,
        max_abs_err=max(errs_s), ms=sum(d["attn_ms"] for d in swin),
        plain_ms=sum(d["attn_plain_ms"] for d in swin),
        bound_ms=sum(d["attn_bound"][0] for d in swin),
        bound_by=max(swin, key=lambda d: d["attn_bound"][0])["attn_bound"][1],
        library_ms=sum(d["attn_library_ms"] for d in swin),
        times_are="one call at each of the four Swin-T stage shapes (the "
                  "shifted block where the stage has one), summed",
        ms_by_stage=[d["attn_ms"] for d in swin])
    emit({"phase": "ppoly_kernels", "equal": True,
          "config": "DeiT-S and Swin-T, gelu and softmax ppoly_backend_ibert",
          "deit_small": deit | {"mlp_bound_ms": bound(mlp_ops, mlp_nb),
                                "attn_bound_ms": bound(attn_ops, attn_nb)},
          "swin_tiny": swin, "max_abs_err": max(errs_m + errs_a + errs_s + errs_ms)})


INT16 = "8,8,8,8,16,8,16,8"    # the reference's INT16 run: softmax, norm2_in 16
# (gelu, softmax, ln) of each family's spec, and as the kernels name them
INT16_SPECS = {"ivit": IVIT, "ibert": ("ibert",) * 3, "ppoly": (PPOLY, PPOLY, "ibert")}
INT16_KERNEL_MIX = {"ivit": IVIT, "ibert": ("ibert",) * 3, "ppoly": ("ppoly", "ppoly", "ibert")}


def deit_block(torch, dev, fam, bits=INT16, **small):
    """Block 0 of the synthetic DeiT-S spec of one family at ``bits``
    (``small``: config fields to cut, as embed_dim and num_heads)."""
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
    gelu, softmax, ln = INT16_SPECS[fam]
    cfg = deit_small_config(depth=1, img_size=64 if small else 224, ln=ln, gelu=gelu,
                            softmax=softmax, bitwidths=bits)
    cfg = dataclasses.replace(cfg, **small)
    return block_args(torch, synthetic_spec(cfg, 0).params["blocks"][0], dev)


def family_kwargs(b, fam, which):
    """The ppoly leaves of one half-block's kernel (none for the others)."""
    if fam != "ppoly":
        return {}
    return ppoly_sm_kwargs(b) if which == "attn" else ppoly_gelu_kwargs(b, True)


def int16_kernel_phase(torch, kb, dev, rows):
    """Phase 16: the INT16 variants at DeiT-S shapes, each bitwise against
    its plain version, fast flags on and off, ivit, ibert and ppoly:
    ``attn_block`` at ``sm_bit`` 16 with an int16 output (int8 in), full and
    padded (17 of 24 tokens), the LN in the kernel and hoisted;
    ``mlp_block`` from int16 rows to int8, the LN in the kernel and
    hoisted.  Times beside the 8-bit variants and, for the MLP, the Swin
    form (int16 in and out) at the same shape; adds the two int16 rows."""
    import numpy as np

    rng = np.random.default_rng(5)

    def stream(shape, bits):
        lim = 2 ** (bits - 1)
        x = np.clip(np.round(rng.normal(0, lim / 4, shape)), -lim, lim - 1)
        return torch.as_tensor(x.astype(np.int16 if bits > 8 else np.int8)).to(dev)

    xa = stream((BATCH, TOKENS, 384), 8)
    xs = stream((2, 24, 384), 8)
    xr = stream((BATCH * TOKENS, 384), 16)
    x8 = stream((BATCH * TOKENS, 384), 8)
    errs_a, errs_m, fams = [], [], {}
    for fam, mix in INT16_KERNEL_MIX.items():
        b, b8 = deit_block(torch, dev, fam), deit_block(torch, dev, fam, "8")
        for flags in (True, False):
            kw = attn_kwargs(b, flags, 6, TOKENS, mix) | family_kwargs(b, fam, "attn") | dict(
                sm_bit=16, out_bits=16)
            got = kb.attn_block(xa, **kw)
            torch.cuda.synchronize()
            errs_a.append(check_equal(torch, f"attn_block int16 {fam} fast={flags}", got,
                                      kb.attn_block_ref(xa, **kw)))
            kws = kw | dict(n_valid=17)
            errs_a.append(check_equal(torch, f"attn_block int16 {fam} padded fast={flags}",
                                      kb.attn_block(xs, **kws), kb.attn_block_ref(xs, **kws),
                                      rows=17))
            kw = mlp_kwargs(b, flags, mix) | family_kwargs(b, fam, "mlp") | dict(
                mlp_bits=8, out_bits=8)
            got = kb.mlp_block(xr, **kw)
            torch.cuda.synchronize()
            errs_m.append(check_equal(torch, f"mlp_block int16->int8 {fam} fast={flags}",
                                      got, kb.mlp_block_ref(xr, **kw)))
        kw_a = attn_kwargs(b, True, 6, TOKENS, mix) | family_kwargs(b, fam, "attn") | dict(
            sm_bit=16, out_bits=16)
        kw_m = mlp_kwargs(b, True, mix) | family_kwargs(b, fam, "mlp") | dict(
            mlp_bits=8, out_bits=8)
        ln_a = kb._ln8(xa, mix[2], kw_a["ln_bias"], kw_a["ln_shift"], kw_a["m_ln"], None)
        ln_m = kb._ln8(xr, mix[2], kw_m["ln_bias"], kw_m["ln_shift"], kw_m["m_ln"], None)
        errs_a.append(check_equal(torch, f"attn_block int16 {fam} ln_in",
                                  kb.attn_block(xa, ln_in=ln_a, **kw_a),
                                  kb.attn_block_ref(xa, ln_in=ln_a, **kw_a)))
        errs_m.append(check_equal(torch, f"mlp_block int16->int8 {fam} ln_in",
                                  kb.mlp_block(xr, ln_in=ln_m, **kw_m),
                                  kb.mlp_block_ref(xr, ln_in=ln_m, **kw_m)))
        kw_a8 = attn_kwargs(b8, True, 6, TOKENS, mix) | family_kwargs(b8, fam, "attn")
        kw_m8 = mlp_kwargs(b8, True, mix) | family_kwargs(b8, fam, "mlp")
        fams[fam] = dict(
            attn_ms=time_ms(torch, lambda: kb.attn_block(xa, **kw_a), iters=20),
            attn_8bit_ms=time_ms(torch, lambda: kb.attn_block(xa, **kw_a8), iters=20),
            mlp_ms=time_ms(torch, lambda: kb.mlp_block(xr, **kw_m), iters=20),
            mlp_swin_form_ms=time_ms(torch, lambda: kb.mlp_block(
                xr, **(kw_m | dict(out_bits=16))), iters=20),
            mlp_8bit_ms=time_ms(torch, lambda: kb.mlp_block(x8, **kw_m8), iters=20),
            ln2_shift=float(b["ln2_shift"]))
        if fam == "ivit":
            fams[fam].update(
                attn_plain_ms=time_ms(torch, lambda: kb.attn_block_ref(xa, **kw_a),
                                      iters=3, warmup=1),
                mlp_plain_ms=time_ms(torch, lambda: kb.mlp_block_ref(xr, **kw_m),
                                     iters=3, warmup=1))
            out16 = kb.attn_block(xa, **kw_a)
            if out16.dtype != torch.int16 or out16.abs().max().item() <= 127:
                raise AssertionError("attn_block int16: the output does not use 16 bits")
    b = deit_block(torch, dev, "ivit")
    xa2, r = xa.reshape(-1, 384), xa.shape[0] * TOKENS
    h = torch.empty((r, 1536), dtype=torch.int8, device=dev)
    attn_lib = time_ms(torch, lambda: (torch._int_mm(xa2, b["qkv_w"]),
                                       torch._int_mm(xa2, b["proj_w"])), iters=20)
    mlp_lib = time_ms(torch, lambda: (torch._int_mm(x8, b["fc1_w"]),
                                      torch._int_mm(h, b["fc2_w"])), iters=20)
    # the bound counts P v as one product, whatever the split; bytes: int8 x
    # in and int16 out (attention), int16 rows in and int8 out (MLP)
    attn_ops = 2 * r * (4 * 384 * 384) + 2 * 2 * BATCH * TOKENS * TOKENS * 384
    out16 = torch.empty((BATCH, TOKENS, 384), dtype=torch.int16, device=dev)
    attn_nb = nbytes(xa, out16, b["qkv_w"], b["proj_w"], b["qkv_b"], b["proj_b"],
                     b["m_qkv"], b["m_proj"], b["m_ln1"], b["ln1_bias_int"])
    mlp_ops = 2 * r * 384 * 1536 * 2
    mlp_nb = nbytes(xr, x8, b["fc1_w"], b["fc2_w"], b["fc1_b"], b["fc2_b"], b["m_fc1"],
                    b["m_fc2"], b["m_ln2"], b["ln2_bias_int"])
    a_ms, a_by = bound(attn_ops, attn_nb)
    m_ms, m_by = bound(mlp_ops, mlp_nb)
    rows["attn_block[int16]"] = dict(
        name="attn_block[int16]", route="cuda", source="ivit_tpu_torch/csrc/attn_block.cu",
        replaces="ivit_tpu/ops/pallas/block.py:1112", launches=None,
        max_abs_err=max(errs_a), ms=fams["ivit"]["attn_ms"],
        plain_ms=fams["ivit"]["attn_plain_ms"], bound_ms=a_ms, bound_by=a_by,
        library_ms=attn_lib, ms_by_family={f: d["attn_ms"] for f, d in fams.items()},
        ms_8bit_by_family={f: d["attn_8bit_ms"] for f, d in fams.items()},
        times_are="DeiT-S [256, 197, 384], 6 heads, sm_bit 16, int8 in, int16 out")
    rows["mlp_block[int16]"] = dict(
        name="mlp_block[int16]", route="cuda", source="ivit_tpu_torch/csrc/mlp_block.cu",
        replaces="ivit_tpu/ops/pallas/block.py:783", launches=None,
        max_abs_err=max(errs_m), ms=fams["ivit"]["mlp_ms"],
        plain_ms=fams["ivit"]["mlp_plain_ms"], bound_ms=m_ms, bound_by=m_by,
        library_ms=mlp_lib, ms_by_family={f: d["mlp_ms"] for f, d in fams.items()},
        ms_swin_form_by_family={f: d["mlp_swin_form_ms"] for f, d in fams.items()},
        ms_8bit_by_family={f: d["mlp_8bit_ms"] for f, d in fams.items()},
        times_are="DeiT-S [50,432, 384], hidden 1536, int16 rows in, int8 out")
    emit({"phase": "int16_kernels", "equal": True, "config": INT16,
          "families": fams, "attn_bound_ms": [a_ms, a_by], "mlp_bound_ms": [m_ms, m_by],
          "attn_library_ms": attn_lib, "mlp_library_ms": mlp_lib,
          "max_abs_err": max(errs_a + errs_m)})


def int16_edge_inputs(torch, b, heads, batch, np_, n_valid, dev):
    """Inputs that drive the 16-bit attention core to its edges, for the
    LN-hoisted kernel (``ln_in``): qkv is the LN output itself (q = k = y,
    v = y scaled so that y = +-127 gives v = 127 / -128 on every channel),
    each image's tokens y = +127 (one hot token), -127 (cold) or 0 (zero)
    on every channel, and its padding keys past ``n_valid`` hot.  The hot
    token's row is one-hot (scores 127 against -127 and 0), the cold rows
    are flat over the cold keys, the zero rows flat over every key.
    ``s_attn`` 0.1 drives the ibert and ppoly exps of the far keys to 0, so
    the hot row's probability is 2**15 - 1; ``m_av`` keeps a one-hot ctx
    inside int8.  Returns (x, ln_in, the operands to override)."""
    from ivit_tpu_torch.engine.freeze import _sym_scale
    from ivit_tpu_torch.ops.ibert import EXP_C

    c = b["qkv_w"].shape[0]
    dh = c // heads
    y = torch.zeros((batch, np_, c), dtype=torch.int8)
    for i in range(batch):
        hot = (37 * i) % n_valid
        y[i, [j for j in range(n_valid) if j % 3]] = -127
        y[i, hot] = 127
        y[i, n_valid:] = 127
    eye = torch.eye(c, dtype=torch.int8)
    s_attn = 0.1
    c_int = float(int(EXP_C / (s_attn * s_attn)))
    over = dict(
        qkv_w=torch.cat([eye, eye, eye], 1), qkv_b=torch.zeros(3 * c, dtype=torch.int32),
        m_qkv=torch.cat([torch.ones(2 * c), torch.full((c,), 128 / 127)]),
        m_attn=torch.tensor(1 / (127 * dh)), s_attn=torch.tensor(s_attn),
        s_exp_act=torch.tensor(float(_sym_scale(16, 0.0, c_int * 2.0**30))),
        m_av=torch.tensor(2.0 ** -15))
    over = {k: v.to(device=dev, dtype=v.dtype if v.dtype != torch.float64
                    else torch.float32).contiguous() for k, v in over.items()}
    x = torch.as_tensor(y).to(dev)
    return x, x, over


def edge_probs(torch, kb, x, kw, heads):
    """The f32 probabilities of the edge inputs before their conversion, as
    the plain version computes them (q = k = x)."""
    b_, n, c = x.shape
    q = x.reshape(b_, n, heads, c // heads).permute(0, 2, 1, 3)
    s = kb._requant(kb.int8_matmul(q, q.transpose(-1, -2)), kw["m_attn"], 8)
    return kb._softmax_probs(s, kw["sm_base"], kw["s_attn"], kw.get("s_exp_act"),
                             kw["sm_bit"], kw["n_valid"], kw["fast_exp"], kw["fast_poly"],
                             kw.get("sm_bounds"), kw.get("sm_coeffs"), 16)


def int16_edge_phase(torch, kb, dev):
    """Phase 17: the attention core at its edges (int16_edge_inputs),
    bitwise against its plain version, each family, 16-bit probabilities
    with an int16 output and 8-bit ones with an int8 output, at DeiT-S
    width (197 tokens, 190 real), at C 64 (24 tokens, 17 real) and at C 128
    with one head (256 tokens, 250 real: head dim 128).  The ibert one-hot
    row's probability rounds to 2**(bits - 1) before its conversion, which
    saturates it at 2**(bits - 1) - 1."""
    checked, top = 0, {}
    for fam, mix in INT16_KERNEL_MIX.items():
        for c, heads, np_, nv, batch in ((384, 6, TOKENS, 190, 4), (64, 2, 24, 17, 2),
                                         (128, 1, 256, 250, 2)):
            small = {} if c == 384 else dict(embed_dim=c, num_heads=heads, num_classes=10)
            b = deit_block(torch, dev, fam, **small)
            x, ln_in, over = int16_edge_inputs(torch, b, heads, batch, np_, nv, dev)
            for bits in (16, 8):
                for flags in (True, False):
                    kw = attn_kwargs(b, flags, heads, nv, mix) | family_kwargs(
                        b, fam, "attn") | dict(sm_bit=bits, out_bits=bits) | over
                    check_equal(torch, f"attn_block edge {fam} bits={bits} C={c} "
                                f"Np={np_} n_valid={nv} fast={flags}",
                                kb.attn_block(x, ln_in=ln_in, **kw),
                                kb.attn_block_ref(x, ln_in=ln_in, **kw), rows=nv)
                    checked += 1
                top[f"{fam} bits={bits} C={c}"] = edge_probs(torch, kb, x, kw, heads).max().item()
    for bits in (16, 8):
        if top[f"ibert bits={bits} C=384"] != 2 ** (bits - 1):
            raise AssertionError(f"edge: the ibert one-hot row's probability is "
                                 f"{top[f'ibert bits={bits} C=384']} before saturation")
    emit({"phase": "int16_edges", "equal": True, "checks": checked,
          "max_probability_before_saturation": top,
          "rows": "one-hot, flat, zero; padded keys hot", "v": [-128, 127]})


def int16_engine_phase(torch, counters, dev, rows, profile=False):
    """Phase 18: the synthetic DeiT-S INT16 ivit and ibert engines (224 px,
    depth 12, batch 256) through ``Engine``: 12 + 12 launches, logits bitwise
    equal to the plain engine on the card and, for 4 images, on the CPU;
    img/s.  Then one DeiT-S float-family forward (gelu and softmax float,
    ibert LN) at batch 4: the fused entry takes the unfused forward (no
    block kernel launches, the final norm's ``ln_requant`` one, logits
    equal to the plain engine's), and the card's
    logits are within the CPU test's bound of the CPU's."""
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec

    gen = torch.Generator(device=dev).manual_seed(3)
    batches = [torch.randn((BATCH, 224, 224, 3), generator=gen, device=dev)
               for _ in range(3)]
    out = {}
    for fam in ("ivit", "ibert"):
        cfg = deit_small_config(ln=fam, gelu=fam, softmax=fam, bitwidths=INT16)
        spec = synthetic_spec(cfg, seed=0)
        eng, plain = Engine(spec), Engine(spec, kernels=False)
        logits, launches = run_counted(torch, counters, lambda: eng(batches[0]))
        want = {k: cfg.depth if k in ("attn_block", "mlp_block") else 0 for k in counters}
        want["ln_requant"] = ln_norms(cfg)
        if launches != want:
            raise AssertionError(f"int16 {fam} forward launched {launches}, want {want}")
        check_logits(torch, f"int16 {fam} kernel engine", logits, plain(batches[0]),
                     cfg.num_classes)
        cpu = Engine(spec, device="cpu", kernels=False)(batches[0][:4].cpu())
        if not torch.equal(logits[:4].cpu(), cpu):
            raise AssertionError(
                f"int16 {fam} kernel engine != plain engine on the CPU (4 images): "
                f"max abs diff {(logits[:4].cpu() - cpu).abs().max().item()}")
        if fam == "ivit":
            rows["attn_block[int16]"]["launches"] = launches["attn_block"]
            rows["mlp_block[int16]"]["launches"] = launches["mlp_block"]
        out[fam] = {"launches_per_forward": launches,
                    "img_per_s": img_per_s(torch, eng, batches, 6),
                    "plain_img_per_s": img_per_s(torch, plain, batches, 2),
                    "logits_std": logits.std().item()}
        if profile:
            emit(profile_forward(torch, f"int16 {fam} kernels=True", eng, batches[0]))
        del eng, plain
    cfg = deit_small_config(ln="ibert", gelu="float", softmax="float")
    spec = synthetic_spec(cfg, seed=0)
    images = batches[1][:4]
    logits, launches = run_counted(torch, counters, lambda: Engine(spec)(images))
    if launches != {k: 0 for k in counters} | {"ln_requant": ln_norms(cfg)}:
        raise AssertionError(f"float forward launched kernels: {launches}")
    check_logits(torch, "float entry", logits, Engine(spec, kernels=False)(images),
                 cfg.num_classes, 4)
    cpu = Engine(spec, device="cpu")(images.cpu())
    diff = (logits.cpu() - cpu).abs().max().item()
    if diff > FLOAT_LOGIT_TOL * cpu.abs().max().item():
        raise AssertionError(f"float forward: card logits off the CPU's by {diff}")
    emit({"phase": "engine_int16",
          "config": f"deit_small 224px depth 12 bitwidths {INT16} (synthetic, seed 0)",
          "batch": BATCH, **out, "equal_plain_cuda": True, "equal_plain_cpu_4img": True,
          "float": {"config": "deit_small gelu/softmax float, ibert LN, batch 4",
                    "max_abs_diff_cpu": diff, "max_abs_logit": cpu.abs().max().item(),
                    "tolerance": f"{FLOAT_LOGIT_TOL} of the largest logit magnitude",
                    "launches": launches}})


def swin_stage_blocks(torch, spec, dev):
    """Per Swin-T stage: (C, heads, windows an image, [(shift, block
    tensors) of its first two blocks]) of a synthetic spec."""
    cfg, stages = spec.config, {}
    for (kind, stage, shift), blk in zip(cfg.layout, spec.params["blocks"]):
        if kind != "block":
            continue
        res = SWIN_GRID // 2 ** stage
        entry = stages.setdefault(stage, (cfg.embed_dim * 2 ** stage,
                                          cfg.stage_heads[stage],
                                          (res // min(7, res)) ** 2, []))
        if len(entry[3]) < 2:
            entry[3].append((shift, block_args(torch, blk, dev)))
    return [stages[i] for i in sorted(stages)]


def swin_attn_kwargs(b, flags, heads, n_windows, shift, mix):
    return dict(ln_bias=b["ln1_bias_int"], m_ln=b["m_ln1"], ln_shift=b["ln1_shift"],
                qkv_w=b["qkv_w"], qkv_b=b["qkv_b"], m_qkv=b["m_qkv"],
                m_attn=b["m_attn"], m_attn2=b["m_attn2"], s_attn=b["s_attn"],
                rel_addend=b["rel_bias_addend"],
                mask_addend=b["mask_int"] if shift else None,
                s_exp_act=b.get("s_exp_act"), m_av=b["m_av"], proj_w=b["proj_w"],
                proj_b=b["proj_b"], m_proj=b["m_proj"], m_res_x=b["m_res1_x"],
                m_res_id=b["m_res1_id"], num_heads=heads, n_windows=n_windows,
                fast_exp=flags, fast_poly=flags, sm_base=mix[1], ln_base=mix[2])


def swin_phases(torch, kb, dev, rows):
    """Phases 9-10: the Swin window-attention kernel and the Swin form of
    the MLP kernel against their plain versions at the Swin-T stage shapes;
    adds the swin_attn_block row and the mlp_block row's Swin times."""
    import numpy as np

    from ivit_tpu_torch.engine.synthetic import swin_tiny_config, synthetic_swin_spec

    rng = np.random.default_rng(1)

    def stream(shape, bits=16):
        lim = 2 ** (bits - 1)
        x = np.clip(np.round(rng.normal(0, lim / 4, shape)), -lim, lim - 1)
        return torch.as_tensor(x.astype(np.int16 if bits > 8 else np.int8)).to(dev)

    ibert = ("ibert", "ibert", "ibert")
    mixes = [ibert] + MIXES
    specs = {}
    for mix in mixes:
        gelu, softmax, ln = mix
        specs[mix] = synthetic_swin_spec(
            swin_tiny_config(gelu=gelu, softmax=softmax, ln=ln), seed=0)
    stages = {m: swin_stage_blocks(torch, specs[m], dev) for m in mixes}
    ln_shifts = sorted({float(b["ln1_shift"]) for _, _, _, blks in stages[ibert]
                        for _, b in blks} | {float(b["ln2_shift"]) for _, _, _, blks
                                             in stages[ibert] for _, b in blks})
    if max(ln_shifts) <= 0:
        raise AssertionError("the ibert Swin-T spec has no LN overflow shift")

    # --- swin_attn_block ---
    errs, per_stage = [], []
    for st, (c, heads, nw, blks) in enumerate(stages[IVIT]):
        x16 = stream((SWIN_BATCH * nw, WIN, c))
        x8 = stream((SWIN_BATCH * nw, WIN, c), 8)
        for mix in mixes:
            for shift, b in stages[mix][st][3]:
                for flags in (True, False):
                    kw = swin_attn_kwargs(b, flags, heads, nw, shift, mix)
                    got = kb.swin_attn_block(x16, **kw)
                    torch.cuda.synchronize()
                    errs.append(check_equal(
                        torch, f"swin_attn_block stage {st} shift {shift} "
                        f"{mix_name(mix)} fast={flags}", got, kb.swin_attn_block_ref(x16, **kw)))
        shift, b = stages[IVIT][st][3][0]
        kw = swin_attn_kwargs(b, True, heads, nw, shift, IVIT)
        errs.append(check_equal(torch, f"swin_attn_block stage {st} int8 input",
                                kb.swin_attn_block(x8, **kw), kb.swin_attn_block_ref(x8, **kw)))
        kw["ln_in"] = kb._ln8(x16, "ivit", kw["ln_bias"], kw["ln_shift"], kw["m_ln"], None)
        errs.append(check_equal(torch, f"swin_attn_block stage {st} ln_in",
                                kb.swin_attn_block(x16, **kw), kb.swin_attn_block_ref(x16, **kw)))
        # timed: the ivit block as the engine runs it (shifted where the stage has one)
        shift, b = stages[IVIT][st][3][-1]
        kw = swin_attn_kwargs(b, True, heads, nw, shift, IVIT)
        ms = time_ms(torch, lambda: kb.swin_attn_block(x16, **kw), iters=20)
        kw_ibert = swin_attn_kwargs(stages[ibert][st][3][-1][1], True, heads, nw, shift, ibert)
        ms_ibert = time_ms(torch, lambda: kb.swin_attn_block(x16, **kw_ibert), iters=20)
        plain_ms = time_ms(torch, lambda: kb.swin_attn_block_ref(x16, **kw), iters=3, warmup=1)
        x2 = torch.clamp(x16, -128, 127).to(torch.int8).reshape(-1, c)
        lib_ms = time_ms(torch, lambda: (torch._int_mm(x2, b["qkv_w"]),
                                         torch._int_mm(x2, b["proj_w"])), iters=20)
        r = x16.shape[0] * WIN
        ops = 2 * r * (3 * c * c + c * c) + 2 * 2 * r * WIN * c
        nb = nbytes(x16, x16, b["qkv_w"], b["proj_w"], b["qkv_b"], b["proj_b"],
                    b["m_qkv"], b["m_proj"], b["m_ln1"], b["ln1_bias_int"],
                    b["rel_bias_addend"], *([b["mask_int"]] if shift else []))
        b_ms, b_by = bound(ops, nb)
        per_stage.append(dict(stage=st, shape=[x16.shape[0], WIN, c], heads=heads,
                              shift=shift, ms=ms, ms_ibert=ms_ibert, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                              int8_ops=ops, bytes=nb))
    # a small ragged case: 147 rows (not a multiple of 64), 16-token windows
    xs = stream((3, 16, 96))
    for mix in mixes:
        bm = stages[mix][0][3][0][1]
        kw = swin_attn_kwargs(bm, True, 3, 3, 0, mix)
        kw["rel_addend"] = bm["rel_bias_addend"][:, :16, :16].contiguous()
        errs.append(check_equal(torch, f"swin_attn_block small ragged {mix_name(mix)}",
                                kb.swin_attn_block(xs, **kw), kb.swin_attn_block_ref(xs, **kw)))
    rows["swin_attn_block"] = dict(
        name="swin_attn_block", route="cuda",
        source="ivit_tpu_torch/csrc/swin_attn_block.cu",
        replaces="ivit_tpu/ops/pallas/block.py:1373", launches=None,
        max_abs_err=max(errs), ms=sum(d["ms"] for d in per_stage),
        plain_ms=sum(d["plain_ms"] for d in per_stage),
        bound_ms=sum(d["bound_ms"] for d in per_stage),
        bound_by=max(per_stage, key=lambda d: d["bound_ms"])["bound_by"],
        library_ms=sum(d["library_ms"] for d in per_stage),
        times_are="one ivit call at each of the four Swin-T stage shapes, summed",
        ms_by_stage=[d["ms"] for d in per_stage],
        bound_ms_by_stage=[d["bound_ms"] for d in per_stage])
    emit({"phase": "swin_attn_block", "equal": True,
          "families_checked": [mix_name(m) for m in mixes] + ["int8 input", "ln_in", "ragged"],
          "ibert_ln_shifts": ln_shifts, "stages": per_stage, "max_abs_err": max(errs)})

    # --- mlp_block, Swin form: int16 rows in and out, fc2 at 8 bits ---
    errs, per_stage = [], []
    for st, (c, heads, nw, blks) in enumerate(stages[IVIT]):
        x = stream((SWIN_BATCH * nw * WIN, c))
        for mix in mixes:
            b = stages[mix][st][3][0][1]
            for flags in (True, False):
                kw = mlp_kwargs(b, flags, mix) | dict(mlp_bits=8, out_bits=16)
                got = kb.mlp_block(x, **kw)
                torch.cuda.synchronize()
                errs.append(check_equal(torch, f"mlp_block swin stage {st} {mix_name(mix)} "
                                        f"fast={flags}", got, kb.mlp_block_ref(x, **kw)))
        b = stages[IVIT][st][3][0][1]
        kw = mlp_kwargs(b, True, IVIT) | dict(mlp_bits=8, out_bits=16)
        kw_ln = kw | dict(ln_in=kb._ln8(x, "ivit", kw["ln_bias"], kw["ln_shift"],
                                        kw["m_ln"], None))
        errs.append(check_equal(torch, f"mlp_block swin stage {st} ln_in",
                                kb.mlp_block(x, **kw_ln), kb.mlp_block_ref(x, **kw_ln)))
        ms = time_ms(torch, lambda: kb.mlp_block(x, **kw), iters=20)
        kw_ibert = mlp_kwargs(stages[ibert][st][3][0][1], True, ibert) | dict(
            mlp_bits=8, out_bits=16)
        ms_ibert = time_ms(torch, lambda: kb.mlp_block(x, **kw_ibert), iters=20)
        plain_ms = time_ms(torch, lambda: kb.mlp_block_ref(x, **kw), iters=3, warmup=1)
        x2 = torch.clamp(x, -128, 127).to(torch.int8)
        h = torch.empty((x.shape[0], 4 * c), dtype=torch.int8, device=dev)
        lib_ms = time_ms(torch, lambda: (torch._int_mm(x2, b["fc1_w"]),
                                         torch._int_mm(h, b["fc2_w"])), iters=20)
        ops = 2 * x.shape[0] * c * 4 * c * 2
        nb = nbytes(x, x, b["fc1_w"], b["fc2_w"], b["fc1_b"], b["fc2_b"],
                    b["m_fc1"], b["m_fc2"], b["m_ln2"], b["ln2_bias_int"])
        b_ms, b_by = bound(ops, nb)
        per_stage.append(dict(stage=st, shape=[x.shape[0], c, 4 * c], ms=ms,
                              ms_ibert=ms_ibert, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by, int8_ops=ops, bytes=nb))
    xs = stream((147, 96))
    for mix in mixes:
        kw = mlp_kwargs(stages[mix][0][3][0][1], True, mix) | dict(mlp_bits=8, out_bits=16)
        errs.append(check_equal(torch, f"mlp_block swin small ragged {mix_name(mix)}",
                                kb.mlp_block(xs, **kw), kb.mlp_block_ref(xs, **kw)))
    rows["mlp_block"].update(
        swin_max_abs_err=max(errs), swin_ms=sum(d["ms"] for d in per_stage),
        swin_plain_ms=sum(d["plain_ms"] for d in per_stage),
        swin_bound_ms=sum(d["bound_ms"] for d in per_stage),
        swin_library_ms=sum(d["library_ms"] for d in per_stage),
        swin_ms_by_stage=[d["ms"] for d in per_stage],
        swin_times_are="one ivit call at each of the four Swin-T stage shapes, summed")
    rows["mlp_block"]["max_abs_err"] = max(rows["mlp_block"]["max_abs_err"], max(errs))
    emit({"phase": "mlp_block_swin", "equal": True,
          "families_checked": [mix_name(m) for m in mixes] + ["ln_in", "ragged"],
          "stages": per_stage, "max_abs_err": max(errs)})


def swin_engine_phase(torch, counters, dev, rows, profile=False):
    """Phase 13: synthetic Swin-T ivit and ibert engines through Engine."""
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.synthetic import swin_tiny_config, synthetic_swin_spec

    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randn((SWIN_BATCH, 224, 224, 3), generator=gen, device=dev)
               for _ in range(3)]
    kernels = ("swin_attn_block", "mlp_block")
    out = {}
    for fam in ("ivit", "ibert"):
        cfg = swin_tiny_config(ln=fam, gelu=fam, softmax=fam)
        spec = synthetic_swin_spec(cfg, seed=0)
        eng, plain = Engine(spec), Engine(spec, kernels=False)
        logits, launches = run_counted(torch, counters, lambda: eng(batches[0]))
        want = {k: cfg.depth if k in kernels else 0 for k in counters}
        want["ln_requant"] = ln_norms(cfg)
        if launches != want:
            raise AssertionError(f"swin {fam} forward launched {launches}, want {want}")
        want_logits, plain_launches = run_counted(torch, counters, lambda: plain(batches[0]))
        if any(plain_launches.values()):
            raise AssertionError(f"swin {fam} plain engine launched {plain_launches}")
        check_logits(torch, f"swin {fam} kernel engine", logits, want_logits,
                     cfg.num_classes, SWIN_BATCH)
        cpu = Engine(spec, device="cpu", kernels=False)(batches[0][:4].cpu())
        if not torch.equal(logits[:4].cpu(), cpu):
            raise AssertionError(
                f"swin {fam} kernel engine != plain engine on the CPU (4 images): "
                f"max abs diff {(logits[:4].cpu() - cpu).abs().max().item()}")
        if fam == "ivit":
            rows["swin_attn_block"]["launches"] = launches["swin_attn_block"]
            rows["mlp_block"]["launches_swin"] = launches["mlp_block"]
            rows["ln_requant"]["launches"]["swin_t_ivit"] = launches["ln_requant"]
        out[fam] = {"launches_per_forward": launches,
                    "img_per_s": img_per_s(torch, eng, batches, 6),
                    "plain_img_per_s": img_per_s(torch, plain, batches, 2),
                    "logits_std": logits.std().item()}
        if profile:
            emit(profile_forward(torch, f"swin {fam} kernels=True", eng, batches[0]))
        del eng, plain
    emit({"phase": "engine_swin",
          "config": "swin_tiny_patch4_window7_224 224px depths (2, 2, 6, 2) "
                    "(synthetic, seed 0)",
          "batch": SWIN_BATCH, "ivit": out["ivit"], "ibert": out["ibert"],
          "equal_plain_cuda": True, "equal_plain_cpu_4img": True})


def check_logits(torch, name, logits, want, classes, batch=BATCH):
    if tuple(logits.shape) != (batch, classes):
        raise AssertionError(f"{name}: logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{name}: non-finite logits")
    if not (logits.std(dim=0) > 0).any():
        raise AssertionError(f"{name}: logits constant across images")
    if not torch.equal(logits, want):
        raise AssertionError(
            f"{name} != plain engine on the card: max abs diff "
            f"{(logits - want).abs().max().item()}")


def ln_norms(cfg, kernels=True):
    """``ln_requant`` launches a forward: one a LayerNorm outside the block
    kernels (ViT's final norm; Swin's patch norm, merges and final norm)
    where the engine launches kernels (``kernels`` True or ``"ops"``), none
    on the plain engine."""
    if kernels is False:
        return 0
    return len(cfg.depths) + 1 if hasattr(cfg, "depths") else 1


def run_counted(torch, counters, fn):
    """Run ``fn`` with every launch count set to 0 just before it; returns
    its result and the counts read just after."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items()}


def img_per_s(torch, fn, batches, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(batches[i % len(batches)])
    torch.cuda.synchronize()
    return n * batches[0].shape[0] / (time.perf_counter() - t0)


def engine_phases(torch, counters, dev, rows, profile=False):
    """Phases 7-8: the DeiT-S ibert and ivit engines through the entry
    points; returns the ibert engine's img/s."""
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec

    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [torch.randn((BATCH, 224, 224, 3), generator=gen, device=dev)
               for _ in range(3)]
    block_kernels = ("attn_block", "mlp_block")
    row_kernels = ("shiftmax", "shift_gelu_requant")

    # --- ibert: the fused block kernels ---
    cfg = deit_small_config()
    spec = synthetic_spec(cfg, seed=0)
    eng, plain = Engine(spec), Engine(spec, kernels=False)
    logits, launches = run_counted(torch, counters, lambda: eng(batches[0]))
    want = {k: cfg.depth if k in block_kernels else 0 for k in counters}
    want["ln_requant"] = ln_norms(cfg)
    if launches != want:
        raise AssertionError(f"ibert forward launched {launches}, want {want}")
    want_logits, plain_launches = run_counted(torch, counters, lambda: plain(batches[0]))
    if any(plain_launches.values()):
        raise AssertionError(f"ibert plain engine launched {plain_launches}")
    check_logits(torch, "ibert kernel engine", logits, want_logits, cfg.num_classes)
    rows["ln_requant"]["launches"]["deit_s_ibert"] = launches["ln_requant"]
    cpu = Engine(spec, device="cpu", kernels=False)(batches[0][:4].cpu())
    if not torch.equal(logits[:4].cpu(), cpu):
        raise AssertionError(
            f"ibert kernel engine != plain engine on the CPU (4 images): max "
            f"abs diff {(logits[:4].cpu() - cpu).abs().max().item()}")
    ibert_img_s = img_per_s(torch, eng, batches, 6)
    emit({"phase": "engine", "config": "deit_small ibert 224px depth 12 (synthetic, seed 0)",
          "batch": BATCH, "launches_per_forward": launches,
          "equal_plain_cuda": True, "equal_plain_cpu_4img": True,
          "img_per_s": ibert_img_s,
          "plain_img_per_s": img_per_s(torch, plain, batches, 2),
          "logits_std": logits.std().item()})
    if profile:
        emit(profile_forward(torch, "ibert kernels=True", eng, batches[0]))
    del eng, plain

    # --- ivit: fused block kernels and standalone nonlinearity kernels ---
    cfg = deit_small_config(ln="ivit", gelu="ivit", softmax="ivit")
    spec = synthetic_spec(cfg, seed=0)
    engines = {True: Engine(spec), "ops": Engine(spec, kernels="ops"),
               False: Engine(spec, kernels=False)}
    want_logits = engines[False](batches[0])
    cpu = Engine(spec, device="cpu", kernels=False)(batches[0][:4].cpu())
    out = {}
    for path, kernels in ((True, block_kernels), ("ops", row_kernels)):
        logits, launches = run_counted(torch, counters,
                                       lambda: engines[path](batches[0]))
        want = {k: cfg.depth if k in kernels else 0 for k in counters}
        want["ln_requant"] = ln_norms(cfg, path)
        if launches != want:
            raise AssertionError(f"ivit kernels={path!r} forward launched "
                                 f"{launches}, want {want}")
        check_logits(torch, f"ivit kernels={path!r} engine", logits, want_logits,
                     cfg.num_classes)
        if not torch.equal(logits[:4].cpu(), cpu):
            raise AssertionError(f"ivit kernels={path!r} engine != plain engine "
                                 "on the CPU (4 images)")
        for k in kernels:
            rows[k]["launches"] = launches[k]
        out[str(path)] = {"launches_per_forward": launches,
                          "img_per_s": img_per_s(torch, engines[path], batches,
                                                 6 if path is True else 4)}
    emit({"phase": "engine_ivit",
          "config": "deit_small ivit 224px depth 12 (synthetic, seed 0)",
          "batch": BATCH, "fused": out["True"], "ops": out["ops"],
          "equal_plain_cuda": True, "equal_plain_cpu_4img": True,
          "plain_img_per_s": img_per_s(torch, engines[False], batches, 2),
          "logits_std": want_logits.std().item()})
    if profile:
        for path in (True, "ops"):
            emit(profile_forward(torch, f"ivit kernels={path!r}", engines[path],
                                 batches[0]))
    return ibert_img_s


def ppoly_engine_phase(torch, counters, dev, rows, profile=False):
    """Phase 15: the synthetic DeiT-S ppoly engine (batch 256) and Swin-T
    ppoly engine (batch 64) through Engine: 12 + 12 launches a forward,
    logits bitwise equal to the plain engine on the card and, for 4
    images, on the CPU; img/s."""
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                                  synthetic_spec, synthetic_swin_spec)

    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for name, cfg, make, batch, img, attn in (
            ("deit_small", deit_small_config(ln="ibert", gelu=PPOLY, softmax=PPOLY),
             synthetic_spec, BATCH, 224, "attn_block"),
            ("swin_tiny", swin_tiny_config(ln="ivit", gelu=PPOLY, softmax=PPOLY),
             synthetic_swin_spec, SWIN_BATCH, 224, "swin_attn_block")):
        spec = make(cfg, seed=0)
        batches = [torch.randn((batch, img, img, 3), generator=gen, device=dev)
                   for _ in range(3)]
        eng, plain = Engine(spec), Engine(spec, kernels=False)
        logits, launches = run_counted(torch, counters, lambda: eng(batches[0]))
        want = {k: cfg.depth if k in (attn, "mlp_block") else 0 for k in counters}
        want["ln_requant"] = ln_norms(cfg)
        if launches != want:
            raise AssertionError(f"{name} ppoly forward launched {launches}, want {want}")
        check_logits(torch, f"{name} ppoly kernel engine", logits, plain(batches[0]),
                     cfg.num_classes, batch)
        cpu = Engine(spec, device="cpu", kernels=False)(batches[0][:4].cpu())
        if not torch.equal(logits[:4].cpu(), cpu):
            raise AssertionError(
                f"{name} ppoly kernel engine != plain engine on the CPU (4 images): "
                f"max abs diff {(logits[:4].cpu() - cpu).abs().max().item()}")
        rows[f"{attn}[ppoly]"]["launches"] = launches[attn]
        key = "launches" if name == "deit_small" else "launches_swin"
        rows["mlp_block[ppoly]"][key] = launches["mlp_block"]
        out[name] = {"batch": batch, "launches_per_forward": launches,
                     "ppoly_fastdiv": spec.config.ppoly_fastdiv,
                     "img_per_s": img_per_s(torch, eng, batches, 6),
                     "plain_img_per_s": img_per_s(torch, plain, batches, 2),
                     "logits_std": logits.std().item()}
        if profile:
            emit(profile_forward(torch, f"{name} ppoly kernels=True", eng, batches[0]))
        del eng, plain
    emit({"phase": "engine_ppoly",
          "config": "deit_small (ibert LN) and swin_tiny_patch4_window7_224 (ivit "
                    "LN), gelu and softmax ppoly_backend_ibert, 224px, full depth "
                    "(synthetic, seed 0)",
          **out, "equal_plain_cuda": True, "equal_plain_cpu_4img": True})


# The qat_freeze phase's configurations: (name, gelu, softmax, ln, bitwidths,
# depth).  DeiT-S at full depth for the ivit and ibert families; the ppoly
# family at depth 2, since its GELU fit takes seconds a site on the host;
# the INT16 bitwidths at depth 4.
QAT_CONFIGS = [("ivit", "ivit", "ivit", "ivit", "8", 12),
               ("ibert", "ibert", "ibert", "ibert", "8", 12),
               ("ppoly", PPOLY, PPOLY, "ibert", "8", 2),
               ("int16", "ivit", "ivit", "ivit", INT16, 4)]
QAT_SEED, QAT_CALIB, QAT_CALIB_BATCH, QAT_BATCH = 0, 2, 8, 64
# A random-init DeiT-S's attention is flat: its calibrated Shiftmax scale
# is about 0.005 (a JAX freeze of this geometry gives 0.0046-0.0049,
# ivit_tpu_torch/engine/synthetic.py), where the 8-bit probabilities of a
# 197-key row all but vanish and the logits barely depend on the image, so
# a bitwise match would pass through dead attention.  Scaling every
# block's qkv kernel by 3 after the seeded init multiplies the scores by 9:
# the calibrated scale lands near the JAX Shiftmax tests'
# (tests/test_pallas.py) and the synthetic ivit spec's (0.052, 0.061); the
# phase prints the share of nonzero probabilities.  Every configuration
# takes the same factor.
QAT_QKV_GAIN = 3.0


def qat_sim(torch, name, device):
    """The phase's seeded DeiT-S QAT sim of configuration ``name`` on
    ``device``: the same parameters on either device (drawn on the CPU)."""
    from ivit_tpu_torch.models import deit_small_patch16_224
    _, gelu, softmax, ln, bits, depth = next(c for c in QAT_CONFIGS if c[0] == name)
    sim = deit_small_patch16_224(depth=depth, gelu_type=gelu, softmax_type=softmax,
                                 layernorm_type=ln, bitwidths=bits, device="cpu",
                                 seed=QAT_SEED)
    with torch.no_grad():
        for blk in sim.blocks:
            blk.attn.qkv.kernel.mul_(QAT_QKV_GAIN)
    return sim.to(device)


def qat_freeze_phase(torch, counters, dev, rows, smi, profile=False):
    """Phase 19: the port's QAT sim and its freeze on the card, for each of
    QAT_CONFIGS: build it from the seed, calibrate it (running_stat) on
    QAT_CALIB seeded batches of QAT_CALIB_BATCH images, fit the ppoly
    tables, freeze; the same on the CPU from the same state and batches,
    whose quant_stats and spec must equal the card's leaf for leaf; at batch
    QAT_BATCH the sim's logits bitwise equal to Engine(spec) on the block
    kernels (depth launches each), to the plain engine and, for ivit, to
    the standalone kernels (INT16 within JAX's bound,
    tests/test_engine.py:144); the ivit probabilities live and the logits
    image-dependent; one backward pass of the full ivit sim.  Timings:
    the sim's img/s, one calibration step, the host freeze, the engine's
    img/s on the frozen and on the synthetic spec; with ``profile``, the
    sim's frozen forward under torch.profiler.  Returns ({name: (spec, sim
    logits)}, the images) for the lut phase."""
    import torch.nn.functional as F
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    from ivit_tpu_torch.models.model_utils import freeze_model as fit_tables

    gen = torch.Generator().manual_seed(QAT_SEED + 11)
    calib = [torch.randn((QAT_CALIB_BATCH, 224, 224, 3), generator=gen)
             for _ in range(QAT_CALIB)]
    images = torch.randn((QAT_BATCH, 224, 224, 3), generator=gen).to(dev)
    out, frozen = {}, {}
    for name, gelu, softmax, ln, bits, depth in QAT_CONFIGS:
        sim, cpu_sim = qat_sim(torch, name, dev), qat_sim(torch, name, "cpu")
        calib_ms = []
        with torch.no_grad():
            for xb in calib:
                xd = xb.to(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sim(xd, running_stat=True)
                torch.cuda.synchronize()
                calib_ms.append((time.perf_counter() - t0) * 1e3)
                cpu_sim(xb, running_stat=True)
        bad = differing_leaves(variables_to_numpy(sim)["quant_stats"],
                               variables_to_numpy(cpu_sim)["quant_stats"])
        if bad:
            raise AssertionError(f"qat {name}: card calibration != CPU's at {bad[:5]}")
        t0 = time.perf_counter()
        spec = freeze_model(fit_tables(sim))
        freeze_s = time.perf_counter() - t0
        cpu_spec = freeze_model(fit_tables(cpu_sim))
        bad = differing_leaves(spec.params, cpu_spec.params)
        if bad or spec.config != cpu_spec.config:
            raise AssertionError(f"qat {name}: card spec != CPU spec at {bad[:5]} "
                                 f"(configs equal: {spec.config == cpu_spec.config})")
        del cpu_sim

        probs = []
        hooks = [b.attn.int_softmax.register_forward_hook(
            lambda mod, args, o: probs.append(float((o[0] != 0).float().mean())))
            for b in sim.blocks]
        with torch.no_grad():
            want = sim(images)
        for h in hooks:
            h.remove()
        live = sum(probs) / len(probs)
        if softmax == "ivit" and live == 0:
            raise AssertionError(f"qat {name}: every probability is 0 (dead attention)")
        if not torch.isfinite(want).all() or not (want.std(dim=0) > 0).any():
            raise AssertionError(f"qat {name}: sim logits non-finite or image-independent")

        paths = {True: ("attn_block", "mlp_block"), False: ()}
        if softmax == "ivit":
            paths["ops"] = ("shiftmax", "shift_gelu_requant")
        results = {}
        for path, kernels in paths.items():
            eng = Engine(spec, kernels=path)
            logits, launches = run_counted(torch, counters, lambda: eng(images))
            expect = {k: depth if k in kernels else 0 for k in counters}
            expect["ln_requant"] = ln_norms(spec.config, path)
            if launches != expect:
                raise AssertionError(f"qat {name} kernels={path!r} launched "
                                     f"{launches}, want {expect}")
            diff = (logits - want).abs().max().item()
            if bits == INT16:
                ok = diff < 1e-5 * want.abs().max().item() + 1e-6
            else:
                ok = torch.equal(logits, want)
            if not ok:
                raise AssertionError(f"qat {name} Engine(kernels={path!r}) != sim: "
                                     f"max abs diff {diff}")
            results[str(path)] = {"launches_per_forward": launches,
                                  "max_abs_diff_sim": diff}
            if path is True:
                results["True"]["img_per_s"] = img_per_s(torch, eng, [images], 4)
                row = {"ppoly": "[ppoly]", "int16": "[int16]"}.get(name, "")
                for k in kernels:
                    rows[k + row][f"launches_qat_{name}"] = launches[k]
            elif path == "ops":
                for k in kernels:
                    rows[k][f"launches_qat_{name}"] = launches[k]
            del eng
        synth = Engine(synthetic_spec(deit_small_config(
            depth=depth, ln=ln, gelu=gelu, softmax=softmax, bitwidths=bits), seed=0))
        synth_img_s = img_per_s(torch, synth, [images], 4)
        del synth
        with torch.no_grad():
            sim_img_s = img_per_s(torch, sim, [images], 2)
            if profile:
                emit(profile_forward(torch, f"qat {name} sim (frozen)", sim, images, n=1))

        entry = {"depth": depth, "bitwidths": bits, "calibration_ms": calib_ms,
                 "freeze_host_s": freeze_s, "sim_img_per_s": sim_img_s,
                 "engine_img_per_s_frozen": results["True"]["img_per_s"],
                 "engine_img_per_s_synthetic": synth_img_s,
                 "nonzero_prob_share": live, "s_attn_block0": float(
                     spec.params["blocks"][0]["s_attn"]),
                 "fast_exp": spec.config.fast_exp, "use_lut": spec.config.use_lut,
                 "paths": results, "logits_std": want.std().item(),
                 "equal_cpu_stats_and_spec": True}
        if name == "ivit":
            labels = torch.arange(QAT_CALIB_BATCH, device=dev)
            loss = F.cross_entropy(sim(calib[0].to(dev)), labels)
            loss.backward()
            grads = {n: p.grad for n, p in sim.named_parameters() if p.grad is not None}
            if not all(torch.isfinite(g).all() for g in grads.values()):
                raise AssertionError("qat ivit backward: non-finite gradients")
            reach = [sim.patch_embed.proj.kernel] + [b.attn.qkv.kernel for b in sim.blocks]
            if any(p.grad is None or p.grad.abs().sum() == 0 for p in reach):
                raise AssertionError("qat ivit backward: no gradient at the patch "
                                     "projection or a block's qkv")
            entry["backward"] = {"images": QAT_CALIB_BATCH, "loss": loss.item(),
                                 "grads_finite": True, "tensors_with_grad": len(grads)}
        out[name] = entry
        frozen[name] = (spec, want)
        del sim
        torch.cuda.empty_cache()
    emit({"phase": "qat_freeze", "nvidia_smi": smi,
          "config": "deit_small_patch16_224 QAT sim, 224px, seed 0, qkv kernels x "
                    f"{QAT_QKV_GAIN}; calibration {QAT_CALIB} x {QAT_CALIB_BATCH} "
                    f"images, eval batch {QAT_BATCH}", **out})
    return frozen, images


# The qat_freeze_swin phase's configurations: (name, gelu, softmax, ln,
# depths), each a seeded Swin-T sim (swin_tiny_patch4_window7_224, 224 px):
# ivit and ibert at full depth, ppoly at depths (2, 2, 2, 2), since its GELU
# fits take some 5 s a site on the host (57 s for the 12 of full depth on
# the H100 machine).  A random-init Swin-T's attention is live (rows of 49
# keys: a nonzero ivit probability share of 0.57-1.0 a block), so no qkv
# gain is taken.
SWIN_QAT_CONFIGS = [("ivit", "ivit", "ivit", "ivit", (2, 2, 6, 2)),
                    ("ibert", "ibert", "ibert", "ibert", (2, 2, 6, 2)),
                    ("ppoly", PPOLY, PPOLY, "ivit", (2, 2, 2, 2))]
SWIN_QAT_CALIB, SWIN_QAT_CALIB_BATCH, SWIN_QAT_BATCH = 2, 8, SWIN_BATCH


def qat_freeze_swin_phase(torch, counters, dev, rows, smi, profile=False):
    """Phase 20: the port's Swin QAT sim and its freeze on the card, for each
    of SWIN_QAT_CONFIGS: build Swin-T from the seed, calibrate it on
    SWIN_QAT_CALIB seeded batches of SWIN_QAT_CALIB_BATCH images, on the
    card and on the CPU from the same state (ranges equal leaf for leaf;
    ppoly's within FLOAT_LOGIT_TOL, since its softmax calibrates through
    the golden float exp before its fit),
    fit the ppoly tables (on the card's sim; the CPU sim takes them: the fit
    runs on the host from the ranges just shown equal), freeze both (specs
    equal leaf for leaf); at batch SWIN_QAT_BATCH the sim's logits bitwise
    equal to Engine(spec) on the block kernels (one swin_attn_block and
    one mlp_block launch a block) and to the plain engine; live ivit attention,
    image-dependent logits, one backward pass of the full ivit sim.
    Timings: the sim's img/s, a calibration step, the host fit and freeze,
    the engine's img/s on the frozen and on the synthetic spec.  Returns
    ({name: (spec, sim logits)}, the images): phase 22 serves the ivit
    spec, the lut phase runs them all."""
    import torch.nn.functional as F
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.swin_int import freeze_swin_model
    from ivit_tpu_torch.engine.synthetic import swin_tiny_config, synthetic_swin_spec
    from ivit_tpu_torch.models import swin_tiny_patch4_window7_224
    from ivit_tpu_torch.models.convert import (differing_leaves, variables_to_numpy,
                                               variables_to_torch)
    from ivit_tpu_torch.models.model_utils import freeze_model as fit_tables

    gen = torch.Generator().manual_seed(QAT_SEED + 20)
    calib = [torch.randn((SWIN_QAT_CALIB_BATCH, 224, 224, 3), generator=gen)
             for _ in range(SWIN_QAT_CALIB)]
    images = torch.randn((SWIN_QAT_BATCH, 224, 224, 3), generator=gen).to(dev)
    out, frozen = {}, {}
    for name, gelu, softmax, ln, depths in SWIN_QAT_CONFIGS:
        sims = [swin_tiny_patch4_window7_224(gelu_type=gelu, softmax_type=softmax,
                                             layernorm_type=ln, depths=depths,
                                             device="cpu", seed=QAT_SEED)
                for _ in range(2)]
        sim, cpu_sim = sims[0].to(dev), sims[1]
        depth = sum(sim.depths)
        calib_ms = []
        with torch.no_grad():
            for xb in calib:
                xd = xb.to(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sim(xd, running_stat=True)
                torch.cuda.synchronize()
                calib_ms.append((time.perf_counter() - t0) * 1e3)
                cpu_sim(xb, running_stat=True)
        card_qs = variables_to_numpy(sim)["quant_stats"]
        cpu_qs = variables_to_numpy(cpu_sim)["quant_stats"]
        off_cpu = differing_leaves(card_qs, cpu_qs)
        calib_rel = 0.0
        if off_cpu and softmax != PPOLY:
            raise AssertionError(f"swin qat {name}: card calibration != CPU's at "
                                 f"{off_cpu[:5]}")
        if off_cpu:
            # before its fit the ppoly softmax runs the golden float exp (JAX
            # layers.py:536-537), whose last ulp differs between the card
            # and the CPU: its ranges are held to the float family's bound
            calib_rel = leaf_rel_diff(card_qs, cpu_qs, off_cpu)
            if calib_rel > FLOAT_LOGIT_TOL:
                raise AssertionError(f"swin qat {name}: card ranges off the CPU's by "
                                     f"{calib_rel} (relative) at {off_cpu[:5]}")
        t0 = time.perf_counter()
        fit_tables(sim)
        fit_s = time.perf_counter() - t0
        # the CPU sim takes the card's fitted state: the fit runs on the host
        # from the ranges (equal but for ppoly's golden exp, above)
        variables_to_torch(cpu_sim, variables_to_numpy(sim))
        t0 = time.perf_counter()
        spec = freeze_swin_model(sim)
        freeze_s = time.perf_counter() - t0
        cpu_spec = freeze_swin_model(cpu_sim)
        bad = differing_leaves(spec.params, cpu_spec.params)
        if bad or spec.config != cpu_spec.config:
            raise AssertionError(f"swin qat {name}: card spec != CPU spec at {bad[:5]} "
                                 f"(configs equal: {spec.config == cpu_spec.config})")
        del cpu_sim, sims

        probs = []
        hooks = [b.attn.int_softmax.register_forward_hook(
            lambda mod, args, o: probs.append(float((o[0] != 0).float().mean())))
            for blocks, _ in sim.stages for b in blocks]
        with torch.no_grad():
            want = sim(images)
        for h in hooks:
            h.remove()
        live = sum(probs) / len(probs)
        if softmax == "ivit" and min(probs) == 0:
            raise AssertionError(f"swin qat {name}: a block's probabilities are all 0")
        if not torch.isfinite(want).all() or not (want.std(dim=0) > 0).any():
            raise AssertionError(f"swin qat {name}: sim logits non-finite or "
                                 "image-independent")
        results = {}
        for path, kernels in ((True, ("swin_attn_block", "mlp_block")), (False, ())):
            eng = Engine(spec, device=dev, kernels=path)
            logits, launches = run_counted(torch, counters, lambda: eng(images))
            expect = {k: depth if k in kernels else 0 for k in counters}
            expect["ln_requant"] = ln_norms(spec.config, path)
            if launches != expect:
                raise AssertionError(f"swin qat {name} kernels={path!r} launched "
                                     f"{launches}, want {expect}")
            if not torch.equal(logits, want):
                raise AssertionError(f"swin qat {name} Engine(kernels={path!r}) != sim: "
                                     f"max abs diff {(logits - want).abs().max().item()}")
            results[str(path)] = {"launches_per_forward": launches}
            if path is True:
                results["True"]["img_per_s"] = img_per_s(torch, eng, [images], 4)
                row = "[ppoly]" if name == "ppoly" else ""
                for k in kernels:
                    rows[k + row][f"launches_qat_swin_{name}"] = launches[k]
            del eng
        synth = Engine(synthetic_swin_spec(swin_tiny_config(
            depths=depths, ln=ln, gelu=gelu, softmax=softmax), seed=0), device=dev)
        synth_img_s = img_per_s(torch, synth, [images], 4)
        del synth
        with torch.no_grad():
            sim_img_s = img_per_s(torch, sim, [images], 2)
            if profile:
                emit(profile_forward(torch, f"swin qat {name} sim (frozen)", sim,
                                     images, n=1))
        entry = {"depths": list(sim.depths), "calibration_ms": calib_ms,
                 "fit_host_s": fit_s, "freeze_host_s": freeze_s,
                 "sim_img_per_s": sim_img_s,
                 "engine_img_per_s_frozen": results["True"]["img_per_s"],
                 "engine_img_per_s_synthetic": synth_img_s,
                 "nonzero_prob_share": live, "nonzero_prob_share_min": min(probs),
                 "s_attn_block0": float(spec.params["blocks"][0]["s_attn"]),
                 "sm_sat_blocks": sum("sm_sat" in b for b in spec.params["blocks"]),
                 "fast_exp": spec.config.fast_exp, "use_lut": spec.config.use_lut,
                 "sm_sum_i32": spec.config.sm_sum_i32, "paths": results,
                 "logits_std": want.std().item(), "equal_cpu_spec": True,
                 "calibration_leaves_off_cpu": len(off_cpu),
                 "first_off_cpu": off_cpu[:3],
                 "calibration_max_rel_diff_cpu": calib_rel}
        if name == "ivit":
            labels = torch.arange(SWIN_QAT_CALIB_BATCH, device=dev)
            loss = F.cross_entropy(sim(calib[0].to(dev)), labels)
            loss.backward()
            grads = {n: p.grad for n, p in sim.named_parameters() if p.grad is not None}
            if not all(torch.isfinite(g).all() for g in grads.values()):
                raise AssertionError("swin qat ivit backward: non-finite gradients")
            blocks = [b for blocks, _ in sim.stages for b in blocks]
            reach = ([sim.patch_embed.proj.kernel] + [b.attn.qkv.kernel for b in blocks]
                     + [b.attn.relative_position_bias_table for b in blocks])
            if any(p.grad is None or p.grad.abs().sum() == 0 for p in reach):
                raise AssertionError("swin qat ivit backward: no gradient at the patch "
                                     "projection, a qkv or a bias table")
            entry["backward"] = {"images": SWIN_QAT_CALIB_BATCH, "loss": loss.item(),
                                 "grads_finite": True, "tensors_with_grad": len(grads)}
        out[name] = entry
        frozen[name] = (spec, want)
        del sim
        torch.cuda.empty_cache()
    emit({"phase": "qat_freeze_swin", "nvidia_smi": smi,
          "config": "swin_tiny_patch4_window7_224 QAT sim, 224px, depths (2, 2, 6, 2) "
                    f"(ppoly (2, 2, 2, 2)), seed {QAT_SEED}, no qkv gain; calibration "
                    f"{SWIN_QAT_CALIB} x "
                    f"{SWIN_QAT_CALIB_BATCH} images, eval batch {SWIN_QAT_BATCH}", **out})
    return frozen, images


class FormCount:
    """One form's launch count of a kernel wrapper (``fn.<attr>``: its table
    form's, ``lut_launches``, or its integer-sqrt LN's,
    ``int_sqrt_launches``), read and reset as ``run_counted`` does a
    wrapper's own count."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.fn, self.attr, value)


class lut_switch:
    """``IVIT_LUT`` (and with ``unfused`` ``IVIT_XLA_LUT``) set inside the
    block, restored after it: the port reads them at each call."""

    def __init__(self, on=True, unfused=False):
        self.want = {"IVIT_LUT": "1" if on else None,
                     "IVIT_XLA_LUT": "1" if on and unfused else None}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.want}
        self._set(self.want)

    def __exit__(self, *exc):
        self._set(self.saved)

    @staticmethod
    def _set(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# The lut phase's families: (name, spec mix (gelu, softmax, ln), kernel mix)
LUT_DEIT = [("ivit", IVIT, IVIT), ("ibert", ("ibert",) * 3, ("ibert",) * 3),
            ("ppoly", (PPOLY, PPOLY, "ibert"), ("ppoly", "ppoly", "ibert"))]
LUT_SWIN = [("ivit", IVIT, IVIT), ("ibert", ("ibert",) * 3, ("ibert",) * 3),
            ("ppoly", (PPOLY, PPOLY, "ivit"), ("ppoly", "ppoly", "ivit"))]
INT_SQRT_LN = "ibert_use-int-sqrt_true"


def lut_phase(torch, kb, counters, dev, rows, smi, vit_frozen, swin_frozen):
    """Phase 21: the freeze-time table forms (``IVIT_LUT``) and the integer-
    sqrt ibert LN of the three block kernels.

    Kernels: each block kernel's table form bitwise equal to its plain
    version with the tables and to its towers (the tables are the towers'
    values), at DeiT-S shapes (ivit, ibert, ppoly; 8-bit and INT16, the
    ivit row sum in one int32 reduction and in two limbs), and at the four
    Swin-T stage shapes of batch 64 (shifted blocks with ``sm_sat``; a
    shifted ppoly block keeps its towers, as JAX's gate says), the tables a
    freeze writes (``synthetic.with_tables``); the three kernels with the
    integer-sqrt LN at DeiT-S and Swin-T stage 0 against their plain
    versions.  Times with the tables on and off.

    Engines: the frozen specs of phases 19-20 (DeiT-S ivit, ibert, ppoly,
    INT16; Swin-T ivit, ibert, ppoly) through ``Engine`` with ``IVIT_LUT``
    set: depth launches of each table form, the logits equal to the sim's
    (INT16 within JAX's bound) and to the towers', and the plain engine's
    table path (``IVIT_XLA_LUT``) equal too; img/s with the tables on and
    off (DeiT-S at batch 256, Swin-T at 64).  Synthetic DeiT-S and Swin-T
    specs with the integer-sqrt LN through ``Engine``: depth launches of
    its form, the logits equal to the plain engine's.  Adds the table-form
    and integer-sqrt rows of the kernel table."""
    import numpy as np

    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                                  synthetic_spec, synthetic_swin_spec,
                                                  with_tables)

    rng = np.random.default_rng(13)

    def stream(shape, bits):
        lim = 2 ** (bits - 1)
        x = np.clip(np.round(rng.normal(0, lim / 4, shape)), -lim, lim - 1)
        return torch.as_tensor(x.astype(np.int16 if bits > 8 else np.int8)).to(dev)

    def on_off(name, fn, ref, kw, tables, gated=None):
        """The table form against its plain version (with the tables the
        gate lets through) and the towers; (max abs err, ms on, ms off)."""
        with lut_switch():
            got = fn(**kw, **tables)
            torch.cuda.synchronize()
            err = check_equal(torch, f"{name} table form", got,
                              ref(**kw, **(tables if gated is None else gated)))
            on = time_ms(torch, lambda: fn(**kw, **tables), iters=20)
        check_equal(torch, f"{name} table form vs towers", got, fn(**kw, **tables))
        return err, on, time_ms(torch, lambda: fn(**kw, **tables), iters=20)

    t_start = time.perf_counter()
    errs = {"attn": [], "mlp": [], "swin": []}
    deit = {}
    xa, xr8, xr16 = (stream((BATCH, TOKENS, 384), 8), stream((BATCH * TOKENS, 384), 8),
                     stream((BATCH * TOKENS, 384), 16))
    for bits in ("8", INT16):
        for fam, mix, kmix in LUT_DEIT:
            gelu, softmax, ln = mix
            spec = with_tables(synthetic_spec(deit_small_config(
                depth=1, ln=ln, gelu=gelu, softmax=softmax, bitwidths=bits), 0))
            if not spec.config.use_lut:
                raise AssertionError(f"lut: the DeiT-S {fam} spec has no tables")
            b = block_args(torch, spec.params["blocks"][0], dev)
            key = fam if bits == "8" else f"{fam}[int16]"
            kw_a = attn_kwargs(b, True, 6, TOKENS, kmix) | family_kwargs(b, fam, "attn")
            kw_m = mlp_kwargs(b, True, kmix) | family_kwargs(b, fam, "mlp")
            if bits == INT16:
                kw_a |= dict(sm_bit=16, out_bits=16)
                kw_m |= dict(mlp_bits=8, out_bits=8)
            xm = xr16 if bits == INT16 else xr8
            entry = {}
            for sum_i32 in ((True, False) if fam == "ivit" else (spec.config.sm_sum_i32,)):
                err, on, off = on_off(f"attn_block {key} sum_i32={sum_i32}", kb.attn_block,
                                      kb.attn_block_ref, kw_a | dict(x=xa),
                                      dict(sm_lut=b["sm_lut"], sm_sum_i32=sum_i32))
                errs["attn"].append(err)
                entry.setdefault("attn_ms_on", on)
                entry["attn_ms_off"] = off
                if fam == "ivit":
                    entry[f"attn_ms_on_sum_i32_{sum_i32}"] = on
            err, entry["mlp_ms_on"], entry["mlp_ms_off"] = on_off(
                f"mlp_block {key}", kb.mlp_block, kb.mlp_block_ref, kw_m | dict(x=xm),
                dict(gelu_lut=b["gelu_lut"]))
            errs["mlp"].append(err)
            if key == "ivit":
                with lut_switch():
                    tables_a = dict(sm_lut=b["sm_lut"], sm_sum_i32=True)
                    entry["attn_plain_ms_on"] = time_ms(
                        torch, lambda: kb.attn_block_ref(xa, **kw_a, **tables_a),
                        iters=2, warmup=1)
                    entry["mlp_plain_ms_on"] = time_ms(
                        torch, lambda: kb.mlp_block_ref(xm, **kw_m, gelu_lut=b["gelu_lut"]),
                        iters=2, warmup=1)
                lib = dict(
                    attn=time_ms(torch, lambda: (torch._int_mm(xa.reshape(-1, 384), b["qkv_w"]),
                                                 torch._int_mm(xa.reshape(-1, 384), b["proj_w"])),
                                 iters=20),
                    mlp=time_ms(torch, lambda: (torch._int_mm(xr8, b["fc1_w"]), torch._int_mm(
                        torch.empty((xr8.shape[0], 1536), dtype=torch.int8, device=dev),
                        b["fc2_w"])), iters=20))
                r = BATCH * TOKENS
                bounds = dict(
                    attn=bound(2 * r * (4 * 384 * 384) + 2 * 2 * BATCH * TOKENS * TOKENS * 384,
                               nbytes(xa, xa, b["qkv_w"], b["proj_w"], b["qkv_b"], b["proj_b"],
                                      b["m_qkv"], b["m_proj"], b["m_ln1"], b["ln1_bias_int"],
                                      b["sm_lut"])),
                    mlp=bound(2 * r * 384 * 1536 * 2,
                              nbytes(xr8, xr8, b["fc1_w"], b["fc2_w"], b["fc1_b"], b["fc2_b"],
                                     b["m_fc1"], b["m_fc2"], b["m_ln2"], b["ln2_bias_int"],
                                     b["gelu_lut"])))
            deit[key] = entry

    swin = {}
    for fam, mix, kmix in LUT_SWIN:
        gelu, softmax, ln = mix
        sspec = with_tables(synthetic_swin_spec(swin_tiny_config(ln=ln, gelu=gelu,
                                                                 softmax=softmax), seed=0))
        if not sspec.config.use_lut:
            raise AssertionError(f"lut: the Swin-T {fam} spec has no tables")
        stages = []
        for st, (c, heads, nw, blks) in enumerate(swin_stage_blocks(torch, sspec, dev)):
            x16 = stream((SWIN_BATCH * nw, WIN, c), 16)
            entry = {"stage": st}
            for shift, sb in blks:
                if ("sm_sat" in sb) != (shift > 0 and fam != "ppoly"):
                    raise AssertionError(f"lut: Swin-T {fam} stage {st} shift {shift}: "
                                         "sm_sat where the freeze's gate says otherwise")
                kw = swin_attn_kwargs(sb, True, heads, nw, shift, kmix) | (
                    ppoly_sm_kwargs(sb) if fam == "ppoly" else {}) | dict(xw=x16)
                tables = dict(sm_lut=sb["sm_lut"], sm_sum_i32=sspec.config.sm_sum_i32,
                              sm_sat=sb.get("sm_sat"))
                gated = tables if "sm_sat" in sb or not shift else {}   # block.py:1486
                err, on, off = on_off(f"swin_attn_block {fam} stage {st} shift {shift}",
                                      kb.swin_attn_block, kb.swin_attn_block_ref, kw,
                                      tables, gated)
                errs["swin"].append(err)
                entry[f"attn_ms_on_shift{shift}"], entry[f"attn_ms_off_shift{shift}"] = on, off
            sb = blks[0][1]
            kw = mlp_kwargs(sb, True, kmix) | dict(mlp_bits=8, out_bits=16) | (
                ppoly_gelu_kwargs(sb, True) if fam == "ppoly" else {}) | dict(
                x=x16.reshape(-1, c))
            err, entry["mlp_ms_on"], entry["mlp_ms_off"] = on_off(
                f"mlp_block swin {fam} stage {st}", kb.mlp_block, kb.mlp_block_ref, kw,
                dict(gelu_lut=sb["gelu_lut"]))
            errs["mlp"].append(err)
            if fam == "ivit":
                shift, lb = blks[-1]
                kw = swin_attn_kwargs(lb, True, heads, nw, shift, kmix) | dict(xw=x16)
                tables = dict(sm_lut=lb["sm_lut"], sm_sum_i32=sspec.config.sm_sum_i32,
                              sm_sat=lb.get("sm_sat"))
                with lut_switch():
                    entry["attn_plain_ms_on"] = time_ms(
                        torch, lambda: kb.swin_attn_block_ref(**kw, **tables), iters=2,
                        warmup=1)
                x2 = torch.clamp(x16, -128, 127).to(torch.int8).reshape(-1, c)
                entry["attn_library_ms"] = time_ms(
                    torch, lambda: (torch._int_mm(x2, lb["qkv_w"]),
                                    torch._int_mm(x2, lb["proj_w"])), iters=20)
                rs = x2.shape[0]
                entry["attn_bound"] = bound(
                    2 * rs * 4 * c * c + 2 * 2 * rs * WIN * c,
                    nbytes(x16, x16, lb["qkv_w"], lb["proj_w"], lb["qkv_b"], lb["proj_b"],
                           lb["m_qkv"], lb["m_proj"], lb["m_ln1"], lb["ln1_bias_int"],
                           lb["rel_bias_addend"], lb["sm_lut"],
                           *([lb["mask_int"]] if shift else [])))
            stages.append(entry)
        swin[fam] = stages
    kernels_s = time.perf_counter() - t_start

    # --- the integer-sqrt ibert LN in the three kernels ---
    isqrt = {}
    spec = synthetic_spec(deit_small_config(depth=1, ln=INT_SQRT_LN), 0)
    b = block_args(torch, spec.params["blocks"][0], dev)
    mix = ("ibert",) * 3
    for name, fn, ref, kw in (
            ("attn_block", kb.attn_block, kb.attn_block_ref,
             attn_kwargs(b, True, 6, TOKENS, mix) | dict(x=xa)),
            ("mlp_block", kb.mlp_block, kb.mlp_block_ref, mlp_kwargs(b, True, mix) | dict(x=xr8))):
        got = fn(use_int_sqrt=True, **kw)
        torch.cuda.synchronize()
        isqrt[name] = dict(
            max_abs_err=check_equal(torch, f"{name} integer sqrt", got,
                                    ref(use_int_sqrt=True, **kw)),
            ms=time_ms(torch, lambda: fn(use_int_sqrt=True, **kw), iters=20),
            ms_floor_sqrt=time_ms(torch, lambda: fn(**kw), iters=20),
            plain_ms=time_ms(torch, lambda: ref(use_int_sqrt=True, **kw), iters=2, warmup=1))
    sspec = synthetic_swin_spec(swin_tiny_config(ln=INT_SQRT_LN, gelu="ibert",
                                                 softmax="ibert"), seed=0)
    c, heads, nw, blks = swin_stage_blocks(torch, sspec, dev)[0]
    x16 = stream((SWIN_BATCH * nw, WIN, c), 16)
    errs_sq = []
    for shift, sb in blks:
        kw = swin_attn_kwargs(sb, True, heads, nw, shift, mix) | dict(xw=x16)
        errs_sq.append(check_equal(
            torch, f"swin_attn_block integer sqrt shift {shift}",
            kb.swin_attn_block(use_int_sqrt=True, **kw),
            kb.swin_attn_block_ref(use_int_sqrt=True, **kw)))
    sb = blks[0][1]
    kw = swin_attn_kwargs(sb, True, heads, nw, 0, mix) | dict(xw=x16)
    x2 = torch.clamp(x16, -128, 127).to(torch.int8).reshape(-1, c)
    rs = x2.shape[0]
    isqrt["swin_attn_block"] = dict(
        max_abs_err=max(errs_sq),
        ms=time_ms(torch, lambda: kb.swin_attn_block(use_int_sqrt=True, **kw), iters=20),
        ms_floor_sqrt=time_ms(torch, lambda: kb.swin_attn_block(**kw), iters=20),
        plain_ms=time_ms(torch, lambda: kb.swin_attn_block_ref(use_int_sqrt=True, **kw),
                         iters=2, warmup=1),
        library_ms=time_ms(torch, lambda: (torch._int_mm(x2, sb["qkv_w"]),
                                           torch._int_mm(x2, sb["proj_w"])), iters=20),
        bound=bound(2 * rs * 4 * c * c + 2 * 2 * rs * WIN * c,
                    nbytes(x16, x16, sb["qkv_w"], sb["proj_w"], sb["qkv_b"], sb["proj_b"],
                           sb["m_qkv"], sb["m_proj"], sb["m_ln1"], sb["ln1_bias_int"],
                           sb["rel_bias_addend"])))
    kw = mlp_kwargs(blks[0][1], True, mix) | dict(mlp_bits=8, out_bits=16, x=x16.reshape(-1, c))
    isqrt["mlp_block_swin"] = dict(max_abs_err=check_equal(
        torch, "mlp_block swin integer sqrt", kb.mlp_block(use_int_sqrt=True, **kw),
        kb.mlp_block_ref(use_int_sqrt=True, **kw)))

    # --- the main path: the frozen specs through Engine, tables on ---
    engines = {}
    launches_by = {}
    big = torch.randn((BATCH, 224, 224, 3), generator=torch.Generator().manual_seed(21)).to(dev)
    for kind, (frozen, images), attn in (("deit", vit_frozen, "attn_block"),
                                         ("swin", swin_frozen, "swin_attn_block")):
        for name, (spec, want) in frozen.items():
            label = f"{kind}_{name}"
            if not spec.config.use_lut:
                raise AssertionError(f"lut: the frozen {label} spec has no tables")
            layout = getattr(spec.config, "layout", None) or [("block", 0, 0)] * len(
                spec.params["blocks"])
            blocks = [(sh, b) for (kind, _, sh), b in zip(layout, spec.params["blocks"])
                      if kind == "block"]
            # a shifted block without sm_sat keeps its towers (block.py:1486)
            tables = sum(sh == 0 or "sm_sat" in b for sh, b in blocks)
            eng = Engine(spec)
            towers = eng(images)
            with lut_switch():
                logits, launches = run_counted(torch, counters, lambda: eng(images))
            expect = {k: 0 for k in counters} | {
                attn: len(blocks), "mlp_block": len(blocks), "mlp_block[lut]": len(blocks),
                f"{attn}[lut]": tables, "ln_requant": ln_norms(spec.config)}
            if launches != expect:
                raise AssertionError(f"lut {label} launched {launches}, want {expect}")
            launches_by[label] = launches
            check_equal(torch, f"lut {label} Engine tables vs towers", logits, towers)
            diff = (logits - want).abs().max().item()
            if name == "int16":
                ok = diff < 1e-5 * want.abs().max().item() + 1e-6
            else:
                ok = torch.equal(logits, want)
            if not ok:
                raise AssertionError(f"lut {label}: Engine with tables != sim: {diff}")
            with lut_switch(unfused=True):
                plain = Engine(spec, kernels=False)(images)
            check_equal(torch, f"lut {label} plain engine with tables", plain, towers)
            entry = {"launches": launches, "max_abs_diff_sim": diff}
            if name in ("ivit", "ibert"):
                batch = big if kind == "deit" else images
                entry["img_per_s_off"] = img_per_s(torch, eng, [batch], 4)
                with lut_switch():
                    entry["img_per_s_on"] = img_per_s(torch, eng, [batch], 4)
                entry["batch"] = batch.shape[0]
            engines[label] = entry
            del eng
    for kind, cfg in (("deit", deit_small_config(ln=INT_SQRT_LN)),
                      ("swin", swin_tiny_config(ln=INT_SQRT_LN, gelu="ibert",
                                                softmax="ibert"))):
        spec = (synthetic_spec(cfg, 0) if kind == "deit" else synthetic_swin_spec(cfg, 0))
        images = big if kind == "deit" else big[:SWIN_BATCH]
        attn = "attn_block" if kind == "deit" else "swin_attn_block"
        depth = cfg.depth if kind == "deit" else sum(cfg.depths)
        eng = Engine(spec)
        logits, launches = run_counted(torch, counters, lambda: eng(images))
        expect = {k: depth if k in (attn, "mlp_block", f"{attn}[int_sqrt]",
                                    "mlp_block[int_sqrt]") else 0 for k in counters}
        expect["ln_requant"] = ln_norms(cfg)
        if launches != expect:
            raise AssertionError(f"int_sqrt {kind} launched {launches}, want {expect}")
        launches_by[f"{kind}_int_sqrt"] = launches
        check_logits(torch, f"int_sqrt {kind} engine", logits,
                     Engine(spec, kernels=False)(images), cfg.num_classes, images.shape[0])
        engines[f"{kind}_int_sqrt"] = {"launches": launches,
                                       "img_per_s": img_per_s(torch, eng, [images], 4)}
        del eng

    def row(name, source, replaces, err, ms, plain_ms, bnd, lib, launches, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib, **extra)

    swin_iv = swin["ivit"]
    rows["attn_block[lut]"] = row(
        "attn_block[lut]", "ivit_tpu_torch/csrc/attn_block.cu",
        "ivit_tpu/ops/pallas/block.py:1112", max(errs["attn"]), deit["ivit"]["attn_ms_on"],
        deit["ivit"]["attn_plain_ms_on"], bounds["attn"], lib["attn"],
        launches_by["deit_ivit"]["attn_block[lut]"],
        ms_by_family={k: [d["attn_ms_on"], d["attn_ms_off"]] for k, d in deit.items()},
        times_are="DeiT-S [256, 197, 384], 6 heads, table form on (ms) and the towers "
                  "(ms_by_family: [on, off]); ivit row sum in one int32 reduction")
    rows["mlp_block[lut]"] = row(
        "mlp_block[lut]", "ivit_tpu_torch/csrc/mlp_block.cu",
        "ivit_tpu/ops/pallas/block.py:783", max(errs["mlp"]), deit["ivit"]["mlp_ms_on"],
        deit["ivit"]["mlp_plain_ms_on"], bounds["mlp"], lib["mlp"],
        launches_by["deit_ivit"]["mlp_block[lut]"],
        ms_by_family={k: [d["mlp_ms_on"], d["mlp_ms_off"]] for k, d in deit.items()},
        swin_ms_by_family={f: [[s["mlp_ms_on"], s["mlp_ms_off"]] for s in st]
                           for f, st in swin.items()},
        times_are="DeiT-S [50,432, 384], hidden 1536, table form on (ms) and the towers")
    rows["swin_attn_block[lut]"] = row(
        "swin_attn_block[lut]", "ivit_tpu_torch/csrc/swin_attn_block.cu",
        "ivit_tpu/ops/pallas/block.py:1373", max(errs["swin"]),
        sum(s[f"attn_ms_on_shift{3 if i < 3 else 0}"] for i, s in enumerate(swin_iv)),
        sum(s["attn_plain_ms_on"] for s in swin_iv),
        (sum(s["attn_bound"][0] for s in swin_iv),
         max(swin_iv, key=lambda s: s["attn_bound"][0])["attn_bound"][1]),
        sum(s["attn_library_ms"] for s in swin_iv),
        launches_by["swin_ivit"]["swin_attn_block[lut]"],
        ms_by_family={f: [{k: v for k, v in s.items() if k.startswith("attn_ms")}
                          for s in st] for f, st in swin.items()},
        times_are="one call at each Swin-T stage shape of batch 64 (the shifted block "
                  "where the stage has one, with sm_sat), summed, ivit")
    for name, src, rep_, key, lkey in (
            ("attn_block[int_sqrt]", "attn_block.cu", "1112", "attn_block", "deit_int_sqrt"),
            ("mlp_block[int_sqrt]", "mlp_block.cu", "783", "mlp_block", "deit_int_sqrt"),
            ("swin_attn_block[int_sqrt]", "swin_attn_block.cu", "1373", "swin_attn_block",
             "swin_int_sqrt")):
        d, base = isqrt[key], rows[key]
        bnd = d.get("bound", (base["bound_ms"], base["bound_by"]))
        rows[name] = row(name, f"ivit_tpu_torch/csrc/{src}", f"ivit_tpu/ops/pallas/block.py:{rep_}",
                         d["max_abs_err"], d["ms"], d["plain_ms"], bnd,
                         d.get("library_ms", base["library_ms"]),
                         launches_by[lkey][f"{key}[int_sqrt]"], ms_floor_sqrt=d["ms_floor_sqrt"],
                         times_are=("DeiT-S, ibert family, the LN in the kernel"
                                    if key != "swin_attn_block" else
                                    "Swin-T stage 0 [4096, 49, 96], batch 64, ibert"))
    emit({"phase": "lut", "nvidia_smi": smi, "equal": True,
          "kernel_checks_s": kernels_s, "deit_small": deit, "swin_tiny": swin,
          "int_sqrt": isqrt, "engines": engines, "max_abs_err": max(
              errs["attn"] + errs["mlp"] + errs["swin"])})


def leaf_rel_diff(a, b, paths):
    """The largest |a - b| / |b| over the leaves at ``paths`` of two trees."""
    import numpy as np
    worst = 0.0
    for path in paths:
        x, y = a, b
        for k in path.strip("/").split("/"):
            x, y = x[k], y[k]
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        worst = max(worst, float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30))))
    return worst


# The serving phase's traffic: SERVE_REQUESTS distinct seeded images from
# SERVE_CLIENTS threads, each keeping at most SERVE_WINDOW requests
# outstanding, into ServingEngine(batch_size=BATCH_SERVE, max_wait_ms 5,
# inflight 2) over the synthetic DeiT-S ibert spec; then SERVE_SWIN requests
# of the frozen Swin-T ivit spec, and bursts of SERVE_BURST past max_queue
# SERVE_MAX_QUEUE and past deadline_ms SERVE_DEADLINE_MS.
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_WINDOW, BATCH_SERVE = 2048, 4, 64, 64
SERVE_SWIN, SERVE_BURST, SERVE_MAX_QUEUE, SERVE_DEADLINE_MS = 256, 1024, 128, 20.0


def serve_clients(srv, images, clients, window):
    """``clients`` threads submit disjoint slices of ``images``, each with at
    most ``window`` requests outstanding; returns the futures in image
    order and the wall seconds from the first submit to the last answer."""
    import collections
    import threading
    futs = [None] * len(images)
    errors = []

    def client(idx):
        outstanding = collections.deque()
        try:
            for i in idx:
                if len(outstanding) >= window:
                    outstanding.popleft().result(timeout=300)
                futs[i] = srv.submit(images[i])
                outstanding.append(futs[i])
            for f in outstanding:
                f.result(timeout=300)
        except Exception as exc:          # reported by the caller
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(range(c, len(images), clients),))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving clients failed: {errors[:3]}")
    return futs, wall


def check_served(np, name, futs, want):
    got = np.stack([f.result() for f in futs])
    if got.shape != want.shape or not (got == want).all():
        bad = (got != want).any(axis=-1).nonzero()[0]
        raise AssertionError(f"serving {name}: {len(bad)} answers != Engine(spec) "
                             f"(first request {bad[:4].tolist()})")


def serving_phase(torch, counters, dev, rows, smi, swin_spec, profile=False):
    """Phase 22: ServingEngine on the card.  The DeiT-S ibert synthetic spec
    under SERVE_CLIENTS client threads: every answer bitwise equal to
    Engine(spec) on the same images, 12 + 12 launches a served batch;
    served img/s beside Engine alone at the same batch in this process, and
    p50 / p95 / p99 latency.  Then the frozen Swin-T ivit spec of phase 20,
    bitwise; a burst past max_queue (rejections counted, every admitted
    request answered bitwise) and one past deadline_ms (sheds counted);
    with ``profile``, the card's idle share while it serves."""
    import numpy as np
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.serving import DeadlineExceeded, QueueFull, ServingEngine
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec

    gen = torch.Generator().manual_seed(21)
    images = torch.randn((SERVE_REQUESTS, 224, 224, 3), generator=gen)
    spec = synthetic_spec(deit_small_config(), seed=0)
    eng = Engine(spec, device=dev)
    want = torch.cat([eng(images[i:i + BATCH_SERVE].to(dev)).cpu()
                      for i in range(0, SERVE_REQUESTS, BATCH_SERVE)]).numpy()
    host = images[:BATCH_SERVE].pin_memory()
    alone_host = img_per_s(torch, eng, [host], 16)
    alone_dev = img_per_s(torch, eng, [host.to(dev)], 16)
    images = images.numpy()

    kw = dict(batch_size=BATCH_SERVE, max_wait_ms=5.0, inflight=2, device=dev)
    with ServingEngine(spec, **kw) as srv:
        for c in counters.values():
            c.launches = 0
        futs, wall = serve_clients(srv, images, SERVE_CLIENTS, SERVE_WINDOW)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        m = srv.metrics.summary()
        idle = None
        if profile:
            idle = profile_serving(torch, srv, images[:SERVE_REQUESTS // 4])
    check_served(np, "deit_small ibert", futs, want)
    depth = spec.config.depth
    expect = {k: depth * m["batches"] if k in ("attn_block", "mlp_block") else 0
              for k in counters}
    expect["ln_requant"] = ln_norms(spec.config) * m["batches"]
    if launches != expect:
        raise AssertionError(f"serving launched {launches} in {m['batches']} batches, "
                             f"want {expect}")
    for k in ("attn_block", "mlp_block"):
        rows[k]["launches_served_batch"] = launches[k] // m["batches"]
    served = {"requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
              "window_per_client": SERVE_WINDOW, "batches": m["batches"],
              "served_img_per_s": SERVE_REQUESTS / wall,
              "engine_img_per_s_host_input": alone_host,
              "engine_img_per_s_device_input": alone_dev,
              "latency_ms_p50": m["latency_ms_p50"], "latency_ms_p95": m["latency_ms_p95"],
              "latency_ms_p99": m["latency_ms_p99"], "latency_ms_max": m["latency_ms_max"],
              "launches": launches, "idle_share_serving": idle}
    del eng

    # the frozen Swin-T ivit spec of phase 20
    swin_images = images[:SERVE_SWIN]
    swin_eng = Engine(swin_spec, device=dev)
    swin_want = torch.cat([swin_eng(torch.from_numpy(swin_images[i:i + SWIN_BATCH]).to(dev))
                           .cpu() for i in range(0, SERVE_SWIN, SWIN_BATCH)]).numpy()
    del swin_eng
    with ServingEngine(swin_spec, **kw) as srv:
        futs, wall = serve_clients(srv, swin_images, SERVE_CLIENTS, SERVE_WINDOW)
        ms = srv.metrics.summary()
    check_served(np, "swin_tiny frozen ivit", futs, swin_want)
    swin = {"requests": SERVE_SWIN, "served_img_per_s": SERVE_SWIN / wall,
            "latency_ms_p50": ms["latency_ms_p50"], "latency_ms_p99": ms["latency_ms_p99"]}

    # a burst past max_queue, then one past deadline_ms, from one thread
    burst = images[:SERVE_BURST]
    with ServingEngine(spec, max_queue=SERVE_MAX_QUEUE, **kw) as srv:
        admitted, rejected = {}, 0
        for i, im in enumerate(burst):
            try:
                admitted[i] = srv.submit(im)
            except QueueFull:
                rejected += 1
        idx = sorted(admitted)
        check_served(np, "max_queue burst", [admitted[i] for i in idx], want[idx])
        mq = srv.metrics.summary()
    if rejected == 0 or mq["rejected"] != rejected or len(idx) + rejected != len(burst):
        raise AssertionError(f"max_queue burst: {rejected} rejected, metrics "
                             f"{mq['rejected']}, {len(idx)} admitted")
    with ServingEngine(spec, deadline_ms=SERVE_DEADLINE_MS, **kw) as srv:
        futs = [srv.submit(im) for im in burst]
        answered, shed = [], 0
        for i, f in enumerate(futs):
            try:
                f.result(timeout=300)
                answered.append(i)
            except DeadlineExceeded:
                shed += 1
        check_served(np, "deadline burst", [futs[i] for i in answered], want[answered])
        md = srv.metrics.summary()
    if shed == 0 or md["shed"] != shed or len(answered) + shed != len(burst):
        raise AssertionError(f"deadline burst: {shed} shed, metrics {md['shed']}, "
                             f"{len(answered)} answered")
    emit({"phase": "serving", "nvidia_smi": smi,
          "config": f"ServingEngine batch_size {BATCH_SERVE}, max_wait_ms 5, inflight 2; "
                    "deit_small ibert 224px depth 12 (synthetic, seed 0)",
          "deit_small_ibert": served, "swin_tiny_frozen_ivit": swin,
          "max_queue_burst": {"offered": SERVE_BURST, "max_queue": SERVE_MAX_QUEUE,
                              "rejected": rejected, "answered": len(idx)},
          "deadline_burst": {"offered": SERVE_BURST, "deadline_ms": SERVE_DEADLINE_MS,
                             "shed": shed, "answered": len(answered)},
          "equal_engine": True})


# The train phase's configurations: (name, model, gelu, softmax, ln, distill).
# DeiT-S ivit takes qat_freeze's qkv gain (QAT_QKV_GAIN) and soft distillation
# from a seeded float DeiT-S teacher (bf16, models/vit_float.py); Swin-T
# ibert keeps its default drop-path 0.1, drawn from a CPU generator, so that
# the card's masks are its CPU twin's.  Both at full width and depth.
TRAIN_CONFIGS = [("deit_s_ivit", "deit_small_patch16_224", "ivit", "ivit", "ivit", True),
                 ("swin_t_ibert", "swin_tiny_patch4_window7_224", "ibert", "ibert",
                  "ibert", False)]
# Calibration on TRAIN_CALIB x TRAIN_CALIB_BATCH seeded images; one step of
# TRAIN_GATE_BATCH images on the card and on the CPU from the same state
# (the gate); then TRAIN_STEPS steps of TRAIN_BATCH on one fixed seeded
# batch with seeded labels: step TRAIN_MIXUP_STEP on its Mixup (images and
# soft targets), the last two through MultiSteps (accumulation 2) over the
# same AdamW state; the EMA (decay TRAIN_EMA) after every step; the trained
# sim against its checkpoint and its engines at batch TRAIN_EVAL_BATCH.
TRAIN_CALIB, TRAIN_CALIB_BATCH, TRAIN_GATE_BATCH = 2, 8, 4
TRAIN_BATCH, TRAIN_STEPS, TRAIN_MIXUP_STEP, TRAIN_EVAL_BATCH = 16, 8, 2, 64
TRAIN_LR, TRAIN_EMA, TRAIN_GRAD_RTOL, TRAIN_CLASSES = 5e-4, 0.9, 1e-4, 1000
TRAIN_PROFILE_STEP = 4          # a plain step, profiled under --profile


def train_config(name):
    """The phase's TrainConfig for configuration ``name``: AdamW at
    TRAIN_LR, cosine to lr / 15 over the run, clip 1.0, weight decay 0.05."""
    from ivit_tpu_torch.train.trainer import TrainConfig
    _, model, gelu, softmax, ln, _ = next(c for c in TRAIN_CONFIGS if c[0] == name)
    return TrainConfig(model=model, gelu_type=gelu, softmax_type=softmax,
                       layernorm_type=ln, lr=TRAIN_LR, weight_decay=0.05,
                       clip_grad=1.0, epochs=1, batch_size=TRAIN_BATCH,
                       model_ema_decay=TRAIN_EMA,
                       num_classes=TRAIN_CLASSES, seed=QAT_SEED)


def train_sim(torch, name, device, seed=QAT_SEED):
    """The phase's seeded sim of configuration ``name`` on ``device`` (drawn
    on the CPU: the same on either device)."""
    from ivit_tpu_torch.train.trainer import build_model
    cfg = dataclasses.replace(train_config(name), seed=seed)
    sim = build_model(cfg, device="cpu")
    if cfg.model.startswith("deit"):
        with torch.no_grad():
            for blk in sim.blocks:
                blk.attn.qkv.kernel.mul_(QAT_QKV_GAIN)
    return sim.to(device)


def train_gate(torch, name, sim, cpu_sim, batch, teacher_logits):
    """One step of ``sim`` (on the card) and of its CPU twin from the same
    state and batch (the teacher's logits, if any, computed once): the
    quant_stats equal leaf for leaf, the gradients within TRAIN_GRAD_RTOL of
    each tensor's largest, the params within 2 * lr (Adam normalises: a
    near-zero gradient whose sign differs moves a weight by up to 2 * lr)."""
    import numpy as np
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    from ivit_tpu_torch.train.steps import init_train_state, make_train_step
    from ivit_tpu_torch.train.trainer import build_optimizer
    out = {}
    for where, model in (("card", sim), ("cpu", cpu_sim)):
        tx = build_optimizer(train_config(name), 1)[0]
        kw = {}
        if teacher_logits is not None:
            kw = dict(teacher_fn=lambda images: teacher_logits.to(images.device),
                      distillation_type="soft")
        step = make_train_step(model, tx, TRAIN_CLASSES, **kw)
        t0 = time.perf_counter()
        _, met = step(init_train_state(model, tx), batch,
                      torch.Generator().manual_seed(QAT_SEED + 1))
        seconds = time.perf_counter() - t0
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                 for n, p in model.named_parameters()}
        out[where] = (variables_to_numpy(model), grads, float(met["loss"]), seconds)
    (card_v, card_g, card_loss, _), (cpu_v, cpu_g, cpu_loss, cpu_s) = \
        out["card"], out["cpu"]
    bad = differing_leaves(card_v["quant_stats"], cpu_v["quant_stats"])
    if bad:
        raise AssertionError(f"train {name}: card quant_stats after a step != the "
                             f"CPU's at {bad[:5]}")
    grad_rel = max((card_g[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                   for n, g in cpu_g.items())
    if grad_rel > TRAIN_GRAD_RTOL:
        raise AssertionError(f"train {name}: card gradients off the CPU's by {grad_rel} "
                             "of a tensor's largest")
    worst, off = 0.0, 0
    for path in differing_leaves(card_v["params"], cpu_v["params"]):
        x, y = card_v["params"], cpu_v["params"]
        for k in path.strip("/").split("/"):
            x, y = x[k], y[k]
        d = np.abs(x - y)
        worst, off = max(worst, float(d.max())), off + int((d > 1e-3 * TRAIN_LR).sum())
    if worst > 2 * TRAIN_LR * (1 + 1e-6):
        raise AssertionError(f"train {name}: card params off the CPU's by {worst} > 2 * lr")
    return {"images": TRAIN_GATE_BATCH, "loss_card": card_loss, "loss_cpu": cpu_loss,
            "quant_stats_equal_cpu": True, "grad_max_rel_diff": grad_rel,
            "param_max_abs_diff": worst, "params_off_over_1e-3_lr": off,
            "cpu_step_s": cpu_s}


def train_run(torch, name, sim, batches, teacher_fn, profile=False):
    """A step of ``sim`` on each of ``batches`` (the last two under
    MultiSteps 2 over the same AdamW state), the EMA after each; returns the
    state, the EMA, the last step's transformation and the run's numbers.
    Every loss must be finite and the last below the first.  With
    ``profile`` the step TRAIN_PROFILE_STEP runs under torch.profiler
    (its time then left out of ``step_ms``)."""
    import math
    from ivit_tpu_torch.train.optim import MultiSteps, tree_leaves
    from ivit_tpu_torch.train.steps import init_train_state, make_train_step
    from ivit_tpu_torch.train.trainer import build_optimizer, init_ema, update_ema
    cfg = train_config(name)
    tx = build_optimizer(cfg, len(batches))[0]
    accum = MultiSteps(tx, every_k_schedule=2)
    kw = dict(teacher_fn=teacher_fn, distillation_type="soft") if teacher_fn else {}
    steps = [make_train_step(sim, tx, TRAIN_CLASSES, **kw),
             make_train_step(sim, accum, TRAIN_CLASSES, **kw)]
    state = init_train_state(sim, tx)
    ema = init_ema(state["params"])
    gen = torch.Generator().manual_seed(QAT_SEED + 2)
    losses, step_ms, prof = [], [], None
    for i, batch in enumerate(batches):
        multi = i >= len(batches) - 2
        if i == len(batches) - 2:               # the AdamW state carries over
            ms = accum.init(state["params"])
            ms["inner_opt_state"] = state["opt_state"]
            state["opt_state"] = ms

        def one_step():
            out = steps[multi](state, batch, gen)
            update_ema(ema, out[0]["params"], cfg.model_ema_decay)
            return out[0], float(out[1]["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile and i == TRAIN_PROFILE_STEP:
            (state, loss), prof = profile_call(torch, one_step)
        else:
            state, loss = one_step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"train {name}: loss {losses[-1]} at step {i}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train {name}: the loss did not fall: {losses}")
    if not all(bool(torch.isfinite(e).all()) for e in tree_leaves(ema)):
        raise AssertionError(f"train {name}: non-finite EMA")
    if not accum.has_updated(state["opt_state"]):
        raise AssertionError(f"train {name}: MultiSteps applied no update")
    return state, ema, accum, {"losses": losses, "step_ms": step_ms,
                               "profile_step": prof}


def train_checkpoint(torch, name, sim, state, ema, tx, images, directory):
    """Save the trained state and EMA, read them into a fresh sim (another
    seed) on the card: its logits bitwise equal to ``sim``'s, the optimizer
    state and the EMA leaf for leaf; returns the numbers."""
    import os
    from ivit_tpu_torch.models.convert import differing_leaves
    from ivit_tpu_torch.train.checkpoint import (load_checkpoint, load_meta,
                                                 save_checkpoint, state_dict)
    from ivit_tpu_torch.train.steps import init_train_state
    cfg = train_config(name)
    t0 = time.perf_counter()
    save_checkpoint(directory, state, epoch=0, best_acc1=0.0,
                    model_config=cfg.model_config(), args=dataclasses.asdict(cfg),
                    ema_params=ema)
    save_s = time.perf_counter() - t0
    fresh = train_sim(torch, name, images.device, seed=QAT_SEED + 5)
    t0 = time.perf_counter()
    loaded, meta = load_checkpoint(directory, init_train_state(fresh, tx))
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        want, got = sim(images), fresh(images)
    if not torch.equal(got, want):
        raise AssertionError(f"train {name}: the checkpoint's sim != the trained sim: "
                             f"max abs diff {(got - want).abs().max().item()}")
    bad = differing_leaves(state_dict(state, ema), state_dict(loaded))
    if bad or load_meta(directory)["keys"] != meta["keys"]:
        raise AssertionError(f"train {name}: the checkpoint's state differs at {bad[:5]}")
    return {"bytes": os.path.getsize(os.path.join(directory, "state.msgpack")),
            "save_s": save_s, "load_s": load_s, "logits_equal": True,
            "state_equal": True}, want


def train_engines(torch, name, sim, want, images, counters, rows):
    """Fit and freeze the trained sim; its logits ``want`` bitwise equal to
    Engine(spec) on the block kernels (one launch of each a block), on the
    standalone kernels for an ivit ViT, and to the plain engine."""
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.engine.swin_int import freeze_swin_model
    from ivit_tpu_torch.models.model_utils import freeze_model as fit_tables
    swin = name.startswith("swin")
    t0 = time.perf_counter()
    fit_tables(sim)
    spec = (freeze_swin_model if swin else freeze_model)(sim)
    freeze_s = time.perf_counter() - t0
    depth = sum(sim.depths) if swin else sim.depth
    paths = {True: ("swin_attn_block" if swin else "attn_block", "mlp_block"), False: ()}
    if not swin and sim.softmax_type == "ivit":
        paths["ops"] = ("shiftmax", "shift_gelu_requant")
    results = {}
    for path, kernels in paths.items():
        eng = Engine(spec, device=images.device, kernels=path)
        logits, launches = run_counted(torch, counters, lambda: eng(images))
        expect = {k: depth if k in kernels else 0 for k in counters}
        expect["ln_requant"] = ln_norms(spec.config, path)
        if launches != expect:
            raise AssertionError(f"train {name} kernels={path!r} launched {launches}, "
                                 f"want {expect}")
        if not torch.equal(logits, want):
            raise AssertionError(f"train {name}: Engine(kernels={path!r}) != the trained "
                                 f"sim: max abs diff {(logits - want).abs().max().item()}")
        results[str(path)] = {"launches_per_forward": launches, "max_abs_diff_sim": 0.0}
        for k in kernels:
            rows[k][f"launches_train_{name}"] = launches[k]
        if path is True:
            results["True"]["img_per_s"] = img_per_s(torch, eng, [images], 4)
        del eng
    return {"freeze_s": freeze_s, "paths": results}


def train_phase(torch, counters, dev, rows, smi, profile=False):
    """Phase 23: QAT training on the card, for each of TRAIN_CONFIGS at full
    width and depth: the seeded sim calibrated on the card and its CPU twin
    (ranges equal leaf for leaf); train_gate; train_run (a Mixup step,
    MultiSteps, the EMA, DeiT-S distilled from its float teacher), the loss
    finite and falling; train_checkpoint; train_engines.  Timings: the
    step's ms and img/s, the calibration, the save and load, the freeze."""
    import copy
    import os
    import numpy as np
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    from ivit_tpu_torch.models.vit_float import float_model
    from ivit_tpu_torch.train.data import Mixup
    from ivit_tpu_torch.train.distill import make_teacher_fn
    from ivit_tpu_torch.train.trainer import calibrate

    rng = np.random.default_rng(QAT_SEED + 22)
    calib = [rng.normal(size=(TRAIN_CALIB_BATCH, 224, 224, 3)).astype(np.float32)
             for _ in range(TRAIN_CALIB)]
    images = rng.normal(size=(TRAIN_BATCH, 224, 224, 3)).astype(np.float32)
    labels = rng.integers(0, TRAIN_CLASSES, TRAIN_BATCH)
    mixed, soft = Mixup(num_classes=TRAIN_CLASSES)(images, labels, rng)
    batch = {"image": torch.from_numpy(images).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    batches = [batch] * TRAIN_STEPS
    batches[TRAIN_MIXUP_STEP] = {"image": torch.from_numpy(mixed).to(dev),
                                 "label": torch.from_numpy(soft).to(dev)}
    evals = torch.from_numpy(rng.normal(size=(TRAIN_EVAL_BATCH, 224, 224, 3))
                             .astype(np.float32)).to(dev)
    out = {}
    for name, model, _, _, _, distill in TRAIN_CONFIGS:
        sim, cpu_sim = train_sim(torch, name, dev), train_sim(torch, name, "cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calibrate(sim, calib)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        calibrate(cpu_sim, calib)
        bad = differing_leaves(variables_to_numpy(sim)["quant_stats"],
                               variables_to_numpy(cpu_sim)["quant_stats"])
        if bad:
            raise AssertionError(f"train {name}: card calibration != CPU's at {bad[:5]}")
        teacher_fn = teacher_logits = None
        if distill:
            teacher_fn = make_teacher_fn(float_model(model, device=dev,
                                                     seed=QAT_SEED + 3))
            teacher_logits = teacher_fn(batch["image"][:TRAIN_GATE_BATCH])
            if not torch.isfinite(teacher_logits).all():
                raise AssertionError(f"train {name}: non-finite teacher logits")
        gate = train_gate(torch, name, copy.deepcopy(sim), cpu_sim,
                          {k: v[:TRAIN_GATE_BATCH] for k, v in batch.items()},
                          teacher_logits)
        del cpu_sim
        state, ema, tx, run = train_run(torch, name, sim, batches, teacher_fn,
                                        profile=profile)
        ckpt, want = train_checkpoint(torch, name, sim, state, ema, tx, evals,
                                      os.path.join("build", "train_smoke", name))
        if not torch.isfinite(want).all() or not (want.std(dim=0) > 0).any():
            raise AssertionError(f"train {name}: trained logits non-finite or "
                                 "image-independent")
        engines = train_engines(torch, name, sim, want, evals, counters, rows)
        ms = sorted(run["step_ms"][1:])[len(run["step_ms"][1:]) // 2]
        out[name] = {"model": model, "distill": "soft" if distill else "none",
                     "calibration_s": calib_s, "gate": gate, **run,
                     "step_ms_median": ms, "img_per_s": TRAIN_BATCH / ms * 1e3,
                     "checkpoint": ckpt, **engines}
        emit({"phase": f"train_{name}", "nvidia_smi": smi, **out[name]})
        del sim, state, ema
        torch.cuda.empty_cache()
    emit({"phase": "train", "nvidia_smi": smi,
          "config": f"full width and depth, seed {QAT_SEED}; calibration {TRAIN_CALIB} x "
                    f"{TRAIN_CALIB_BATCH}, gate {TRAIN_GATE_BATCH}, {TRAIN_STEPS} steps "
                    f"of {TRAIN_BATCH} (step {TRAIN_MIXUP_STEP} Mixup, the last two "
                    f"MultiSteps 2), lr {TRAIN_LR}, EMA {TRAIN_EMA}, eval "
                    f"{TRAIN_EVAL_BATCH}",
          **{k: {"step_ms_median": v["step_ms_median"], "img_per_s": v["img_per_s"],
                 "loss_first": v["losses"][0], "loss_last": v["losses"][-1]}
             for k, v in out.items()}})


# The trainer phase: the training CLI (ivit_tpu_torch.scripts.quant_train)
# run in-process on a seeded ImageFolder written under build/trainer_smoke/:
# TRAINER_CLASSES classes of TRAINER_TRAIN train and TRAINER_VAL val images,
# each side drawn in TRAINER_SIDES (so that the random-resized crop both up-
# and downsamples), PNG but every seventh a 24-bit BMP, the pixels integer
# arithmetic on seeded draws (no transcendental: the same bytes on every
# machine).  DeiT-S ivit at full width and depth, 224 px, batch
# TRAINER_BATCH, the reference's augmentation and Mixup defaults, the EMA;
# one epoch, then a second resumed from the first one's checkpoint.
TRAINER_ROOT = "build/trainer_smoke"
TRAINER_CLASSES, TRAINER_TRAIN, TRAINER_VAL, TRAINER_SIDES = 10, 8, 4, (160, 400)
TRAINER_BATCH, TRAINER_AA, TRAINER_THREADS = 16, "rand-m9-mstd0.5-inc1", 8
# sha256 of the first train batch of epoch 0 (image bytes, then label bytes),
# computed through the JAX package's Pillow pipeline on the same folder by
# tests/test_torch_port_data.py::test_trainer_smoke_first_batch_digest
TRAINER_FIRST_BATCH_SHA256 = "df9f7365e6a323ffbe10a70a86be850df7130b5a97334f4159802c5c9e83de3a"
# the JSONL record fields of the JAX trainer (ivit_tpu/train/trainer.py)
TRAINER_LOG_KEYS = {"train": {"ts", "run_id", "phase", "epoch", "loss", "acc", "step"},
                    "epoch": {"ts", "run_id", "phase", "epoch", "train_loss", "loss",
                              "top1", "top5", "best_acc1", "eta_s"}}


def write_png(path, img):
    """An 8-bit RGB PNG of ``img`` (HWC uint8), every row filter 0."""
    import struct
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                                   0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_bmp(path, img):
    """A 24-bit bottom-up BMP of ``img`` (HWC uint8)."""
    import struct
    import numpy as np
    h, w = img.shape[:2]
    stride = (w * 3 + 3) // 4 * 4
    pix = np.zeros((h, stride), np.uint8)
    pix[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, pix.size, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 54 + pix.size, 0, 0, 54) + header
                + pix.tobytes())


def write_trainer_folder(root):
    """The phase's seeded ImageFolder under ``root`` (``train/``, ``val/``):
    a coarse random colour grid blown up in blocks, a gradient and noise."""
    import os
    import numpy as np
    rng = np.random.default_rng(QAT_SEED + 23)
    for split, per_class in (("train", TRAINER_TRAIN), ("val", TRAINER_VAL)):
        for c in range(TRAINER_CLASSES):
            cdir = os.path.join(root, split, f"class_{c:02d}")
            os.makedirs(cdir, exist_ok=True)
            for k in range(per_class):
                h, w = (int(v) for v in rng.integers(TRAINER_SIDES[0],
                                                     TRAINER_SIDES[1] + 1, 2))
                cell = int(rng.integers(8, 40))
                grid = rng.integers(0, 256, (h // cell + 1, w // cell + 1, 3))
                img = np.repeat(np.repeat(grid, cell, 0), cell, 1)[:h, :w]
                yy, xx = np.mgrid[0:h, 0:w]
                img = img + ((xx * (c + 1) + yy * 3) % 64)[..., None] - 32
                img = img + rng.integers(-12, 13, (h, w, 3))
                img = np.clip(img, 0, 255).astype(np.uint8)
                if (c * per_class + k) % 7 == 3:
                    write_bmp(os.path.join(cdir, f"img_{k}.bmp"), img)
                else:
                    write_png(os.path.join(cdir, f"img_{k}.png"), img)


def batch_digest(batch):
    import hashlib
    return hashlib.sha256(batch["image"].tobytes() + batch["label"].tobytes()).hexdigest()


def trainer_argv(out_dir, device, epochs=1, resume=None):
    argv = ["--model", "deit_small_patch16_224", "--data-path", TRAINER_ROOT,
            "--batch-size", str(TRAINER_BATCH), "--epochs", str(epochs),
            "--calibration-batches", "2", "--aa", TRAINER_AA, "--mixup", "0.8",
            "--cutmix", "1.0", "--smoothing", "0.1", "--model-ema", "--lr", "5e-4",
            "--clip-grad", "1.0", "--weight-decay", "0.05", "--seed", str(QAT_SEED),
            "--output-dir", out_dir, "--run-id", "smoke", "--log-interval", "1",
            "--device", device]
    return argv + (["--resume", resume] if resume else [])


def trainer_loader_rates():
    """Gate 1 and the loader's rate: the first train batch of epoch 0 from
    1 and TRAINER_THREADS threads, bitwise equal and at the pinned digest;
    img/s of a whole train pass at TRAINER_THREADS threads, with and
    without RandAugment (host only)."""
    import numpy as np
    from ivit_tpu_torch.train.data import ImageFolderDataset, data_loader
    from ivit_tpu_torch.train.randaug import parse_rand_augment
    ds = ImageFolderDataset(f"{TRAINER_ROOT}/train")
    ra = parse_rand_augment(TRAINER_AA)
    kw = dict(train=True, img_size=224, seed=QAT_SEED)
    first = [next(data_loader(ds, TRAINER_BATCH, rand_augment=ra, num_threads=t, **kw))
             for t in (1, TRAINER_THREADS)]
    for k in ("image", "label"):
        if not np.array_equal(first[0][k], first[1][k]):
            raise AssertionError(f"trainer: the first batch's {k} differs between 1 and "
                                 f"{TRAINER_THREADS} loader threads")
    digest = batch_digest(first[0])
    if digest != TRAINER_FIRST_BATCH_SHA256:
        raise AssertionError(f"trainer: first batch sha256 {digest} != the CPU test's "
                             f"{TRAINER_FIRST_BATCH_SHA256}")
    rates = {}
    for name, aug in (("randaugment", ra), ("no_randaugment", None)):
        t0 = time.perf_counter()
        n = sum(b["image"].shape[0] for b in data_loader(
            ds, TRAINER_BATCH, rand_augment=aug, num_threads=TRAINER_THREADS, **kw))
        rates[name] = n / (time.perf_counter() - t0)
    return {"first_batch_sha256": digest, "threads_equal": [1, TRAINER_THREADS],
            "loader_img_per_s": rates, "loader_threads": TRAINER_THREADS}


class _Timed:
    """Wraps ``trainer``'s loader and its lifecycle methods for the phase's
    clock: the seconds each step of ``train_epoch`` waited on the loader and
    worked (Mixup, the step, the EMA, the logging, up to the next batch),
    and the seconds of each call of ``calibrate``, ``train_epoch``,
    ``validate`` and the checkpoint save.  ``snapshot`` runs after
    ``calibrate``; with ``profile_epoch`` each epoch runs under
    torch.profiler (the card's idle share)."""

    def __init__(self, torch, trainer, snapshot=None, profile_epoch=False):
        import ivit_tpu_torch.train.trainer as mod
        self.torch = torch
        self.wait, self.work, self.calls = [], [], {}
        self.profile, self.in_epoch = None, False
        loader, save = mod.data_loader, mod.ckpt_io.save_checkpoint
        timed = self

        def data_loader(*args, **kw):
            it = loader(*args, **kw)
            t0 = time.perf_counter()
            while True:
                try:
                    batch = next(it)
                except StopIteration:
                    return
                t1 = time.perf_counter()
                yield batch
                torch.cuda.synchronize()
                t = time.perf_counter()
                if timed.in_epoch:
                    timed.wait.append(t1 - t0)
                    timed.work.append(t - t1)
                t0 = t

        self._patches = [(mod, "data_loader", loader, data_loader),
                         (mod.ckpt_io, "save_checkpoint", save, self._clock("save", save))]
        for name in ("calibrate", "train_epoch", "validate"):
            fn = getattr(trainer, name)
            if name == "train_epoch" and profile_epoch:
                fn = self._profiled(fn)
            wrapped = self._clock(name, fn)
            if name == "calibrate" and snapshot is not None:
                wrapped = self._after(wrapped, snapshot)
            self._patches.append((trainer, name, None, wrapped))

    def _clock(self, name, fn):
        def run(*args, **kw):
            self.torch.cuda.synchronize()
            self.in_epoch = name == "train_epoch"
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.calls.setdefault(name, []).append(time.perf_counter() - t0)
            self.in_epoch = False
            return out
        return run

    def _after(self, fn, then):
        def run(*args, **kw):
            out = fn(*args, **kw)
            then()
            return out
        return run

    def _profiled(self, fn):
        def run(*args, **kw):
            out, self.profile = profile_call(self.torch, lambda: fn(*args, **kw))
            return out
        return run

    def __enter__(self):
        for obj, name, _, new in self._patches:
            setattr(obj, name, new)
        return self

    def __exit__(self, *exc):
        for obj, name, old, _ in self._patches:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)

    def numbers(self):
        wait, work = sum(self.wait), sum(self.work)
        steps = len(self.work)
        out = {"steps": steps, "loader_wait_share": wait / max(wait + work, 1e-9),
               "step_ms_mean": work / max(steps, 1) * 1e3,
               "img_per_s": steps * TRAINER_BATCH / max(work, 1e-9),
               **{f"{k}_s": v for k, v in self.calls.items()}}
        if self.profile is not None:
            out["epoch_profile"] = self.profile
        return out


def trainer_log_check(path):
    """Gate 3's log half: every record has the JAX trainer's fields and
    every loss is finite; returns the records."""
    import math
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        if set(r) != TRAINER_LOG_KEYS[r["phase"]]:
            raise AssertionError(f"trainer: log record fields {sorted(r)} != JAX's "
                                 f"{sorted(TRAINER_LOG_KEYS[r['phase']])}")
        for k in ("loss", "train_loss"):
            if k in r and not math.isfinite(r[k]):
                raise AssertionError(f"trainer: non-finite {k} in {r}")
    return recs


def trainer_phase(torch, counters, dev, rows, smi, profile=False):
    """Phase 24: train from image files through the CLI, in-process.  The
    seeded folder; gate 1 (the first batch, bitwise across thread counts,
    at the pinned digest) and the loader's rates; the card Trainer built by
    ``quant_train.build_trainer`` from the CLI's flags, qkv scaled by
    QAT_QKV_GAIN, fitted for one epoch; gate 2 (its calibration equal to a
    CPU Trainer's leaf for leaf); gate 3 (every logged loss finite, JAX's
    log fields; a second epoch resumed from the checkpoint at epoch 1 with
    the saved step, optimizer state and EMA); gate 4 (the trained sim
    frozen, its logits on the first val batch equal to Engine(spec)'s on
    both kernel paths and the plain engine)."""
    import os
    import shutil
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    from ivit_tpu_torch.scripts import quant_train
    from ivit_tpu_torch.train.checkpoint import state_dict
    from ivit_tpu_torch.train.data import data_loader

    shutil.rmtree(TRAINER_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    write_trainer_folder(TRAINER_ROOT)
    out = {"folder_s": time.perf_counter() - t0}
    out.update(trainer_loader_rates())

    def gained(trainer):
        with torch.no_grad():
            for blk in trainer.model.blocks:
                blk.attn.qkv.kernel.mul_(QAT_QKV_GAIN)
        return trainer

    runs = os.path.join(TRAINER_ROOT, "runs")
    card = gained(quant_train.build_trainer(quant_train.parse_args(
        trainer_argv(runs, "cuda"))))
    calibrated = {}

    def snapshot():
        calibrated["quant_stats"] = variables_to_numpy(card.model)["quant_stats"]
    with _Timed(torch, card, snapshot) as timed:
        card.fit()
    out["epoch_0"] = timed.numbers()

    t0 = time.perf_counter()
    cpu = gained(quant_train.build_trainer(quant_train.parse_args(
        trainer_argv(os.path.join(runs, "cpu"), "cpu"))))
    cpu.calibrate()
    out["cpu_calibration_s"] = time.perf_counter() - t0
    bad = differing_leaves(calibrated["quant_stats"],
                           variables_to_numpy(cpu.model)["quant_stats"])
    if bad:
        raise AssertionError(f"trainer: card calibration != the CPU Trainer's at {bad[:5]}")
    del cpu

    ckpt = os.path.join(runs, "checkpoint_smoke")
    saved = state_dict(card.state, card.ema_params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = quant_train.build_trainer(quant_train.parse_args(
        trainer_argv(runs, "cuda", epochs=2, resume=ckpt)))
    torch.cuda.synchronize()
    out["resume_s"] = time.perf_counter() - t0
    if resumed.start_epoch != 1 or int(resumed.state["step"]) != int(card.state["step"]):
        raise AssertionError(f"trainer: resumed at epoch {resumed.start_epoch}, step "
                             f"{int(resumed.state['step'])}; saved epoch 0, step "
                             f"{int(card.state['step'])}")
    bad = differing_leaves(saved, state_dict(resumed.state, resumed.ema_params))
    if bad:
        raise AssertionError(f"trainer: the resumed state differs from the saved at {bad[:5]}")
    del card
    with _Timed(torch, resumed, profile_epoch=profile) as timed:
        resumed.fit()
    out["epoch_1"] = timed.numbers()
    recs = trainer_log_check(os.path.join(runs, "log_smoke.jsonl"))
    if [r["epoch"] for r in recs if r["phase"] == "epoch"] != [0, 1]:
        raise AssertionError(f"trainer: epoch records {recs}")
    out["losses"] = [r["loss"] for r in recs if r["phase"] == "train"]
    out["val"] = {k: recs[-1][k] for k in ("loss", "top1", "top5")}

    val = next(data_loader(resumed.ds_val, TRAINER_BATCH, train=False, img_size=224,
                           drop_last=True))
    images = torch.from_numpy(val["image"]).to(dev)
    sim = resumed.model
    with torch.no_grad():
        want = sim(images)
    if not torch.isfinite(want).all() or not (want.std(dim=0) > 0).any():
        raise AssertionError("trainer: trained logits non-finite or image-independent")
    out.update(train_engines(torch, "trainer_deit_s", sim, want, images, counters, rows))
    emit({"phase": "trainer", "nvidia_smi": smi,
          "config": f"quant_train CLI in-process: deit_small_patch16_224 ivit 224px depth "
                    f"12, {TRAINER_CLASSES} classes x {TRAINER_TRAIN} train / "
                    f"{TRAINER_VAL} val images ({TRAINER_SIDES[0]}-{TRAINER_SIDES[1]} "
                    f"px, PNG + BMP), batch {TRAINER_BATCH}, aa {TRAINER_AA}, mixup 0.8 "
                    f"cutmix 1.0 smoothing 0.1, EMA, lr 5e-4, clip 1.0, wd 0.05, "
                    f"calibration 2 batches, epoch 0 then epoch 1 resumed, qkv x "
                    f"{QAT_QKV_GAIN}", **out})


# The compat_cli phase: the user's path from a checkpoint through the CLIs,
# at DeiT-S full width and depth (Swin-T for the Swin round trip).
COMPAT_CALIB, COMPAT_CLI_BATCH, COMPAT_CLI_BATCHES = 2, 256, 4
COMPAT_SERVE_BATCH, COMPAT_SERVE_BATCHES = 64, 8
# serving_bench: the requests a point (the script's default is 2,048) and the
# batch sizes, cut to fit the phase's budget
COMPAT_REQUESTS, COMPAT_BENCH_BATCHES = 256, "1,8,32,64"
COMPAT_TRAIN_SAMPLES, COMPAT_TRAIN_BATCH = 32, 16      # two steps


def compat_model_config(name, fam):
    """The model_config the training CLI persists, all bitwidths 8."""
    cfg = {"model": name, "gelu_type": fam, "softmax_type": fam, "layernorm_type": fam}
    for site in ("patch_embed", "pos_encoding", "block_input", "attention_out",
                 "softmax", "mlp_out", "norm2_in", "att_block_out"):
        cfg[f"{site}_bitwidth"] = 8
    return cfg


def compat_round_trip(torch, counters, dev, name, sim, fresh, images, directory,
                      fam, kernels):
    """Write ``sim`` (calibrated) as a reference checkpoint, load it into
    ``fresh``: every leaf equal, nothing missing; ``Engine(freeze(fresh))``
    on the block kernels (``kernels``, depth launches each) gives the
    original sim's logits bitwise.  Returns (path, numbers)."""
    import os
    from ivit_tpu_torch.compat.export_torch import save_reference_checkpoint
    from ivit_tpu_torch.compat.torch_ckpt import load_into_model
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.engine.swin_int import freeze_swin_model
    from ivit_tpu_torch.models import SwinTransformer
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy

    path = os.path.join(directory, f"{name}.pth.tar")
    cfg = compat_model_config(name, fam)
    variables = variables_to_numpy(sim)
    t0 = time.perf_counter()
    save_reference_checkpoint(variables, cfg, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, report = load_into_model(fresh, path)
    load_s = time.perf_counter() - t0
    bad = differing_leaves(variables_to_numpy(fresh), variables)
    if bad or report["missing"] or report["model_config"] != cfg:
        raise AssertionError(f"compat {name}: reloaded leaves differ at {bad[:5]}, "
                             f"missing {report['missing'][:5]}")
    with torch.no_grad():
        want = sim(images)
    freeze = freeze_swin_model if isinstance(fresh, SwinTransformer) else freeze_model
    spec = freeze(fresh)
    eng = Engine(spec)
    logits, launches = run_counted(torch, counters, lambda: eng(images))
    expect = {k: 12 if k in kernels else 0 for k in counters}
    expect["ln_requant"] = ln_norms(spec.config)
    if launches != expect:
        raise AssertionError(f"compat {name}: Engine launched {launches}, want {expect}")
    if not torch.isfinite(want).all() or not torch.equal(logits, want):
        raise AssertionError(f"compat {name}: the reloaded engine != the original sim: max "
                             f"abs diff {(logits - want).abs().max().item()}")
    return path, {"leaves": len(report["matched"]), "missing": 0, "save_s": save_s,
                  "load_s": load_s, "launches_per_forward": launches,
                  "file_mb": os.path.getsize(path) / 2**20, "equal_sim": True}


def topk_counts(np, logits, labels):
    order = np.argsort(-logits, axis=-1)
    return [int((order[:, :k] == labels[:, None]).any(-1).sum()) for k in (1, 5)]


def compat_cli_phase(torch, counters, dev, rows, smi, engine_img_s):
    """Phase 25: checkpoint interop and the CLIs, in-process, in a temporary
    directory.  (a) Seeded DeiT-S ibert and Swin-T ivit sims on the card,
    calibrated on COMPAT_CALIB x QAT_CALIB_BATCH images (DeiT-S qkv x
    QAT_QKV_GAIN), written as reference checkpoints and loaded into fresh
    sims of another seed: every leaf equal, none missing, the reloaded
    engines' logits (12 + 12 launches) the originals' bitwise.  (b) The
    inference CLI on the DeiT-S checkpoint (batch 256, 4 batches, one
    calibration batch, the artifact and the IO stats written): 12 launches
    of each block kernel a forward; the artifact's Engine == the sim
    recalibrated on the same batch; the CSV's layers those of the CPU's
    attach_io_stats; its img/s.  (c) engine_inference on the artifact:
    the inference CLI's top-1 / top-5 counts; --serve at batch 64: the
    counts of Engine(spec)'s logits on the same images, and the server's
    answers bitwise Engine(spec)'s.  (d) serving_bench (DeiT-S ibert,
    COMPAT_REQUESTS a point): JAX's keys, every overload point adding up.
    (e) analyze_io_stats' engine audit (DeiT-S ibert, batch 4): no hard
    violation, the card's records the CPU's; the fused DeiT-S ibert
    engine's img/s with the taps present and no capture, beside the
    engine phase's.  (f) quant_train --pretrained with a seeded timm-style
    float DeiT-S file: the sim's parameters the file's, two steps of 16,
    finite losses."""
    import contextlib
    import copy
    import io
    import json
    import os
    import tempfile

    import numpy as np

    from ivit_tpu_torch.compat.torch_ckpt import (convert_state_dict, load_into_model,
                                                  load_torch_checkpoint)
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.export import load_engine
    from ivit_tpu_torch.engine.serving import ServingEngine
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
    from ivit_tpu_torch.models import deit_small_patch16_224, swin_tiny_patch4_window7_224
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    from ivit_tpu_torch.models.vit_float import float_model, timm_state_dict
    from ivit_tpu_torch.scripts import (analyze_io_stats, engine_inference, inference,
                                        quant_train, serving_bench)
    from ivit_tpu_torch.train.data import SyntheticDataset, data_loader
    from ivit_tpu_torch.utils.iostats import attach_io_stats, clear_io_stats, get_io_stats

    t_phase = time.perf_counter()
    out, step_s = {}, {}

    def lap(name, since):
        step_s[name] = time.perf_counter() - since
        return time.perf_counter()
    gen = torch.Generator().manual_seed(QAT_SEED + 21)
    calib = [torch.randn((QAT_CALIB_BATCH, 224, 224, 3), generator=gen)
             for _ in range(COMPAT_CALIB)]
    images = torch.randn((QAT_BATCH, 224, 224, 3), generator=gen).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) reference-schema round trips
        sims = {"deit_small_patch16_224": (qat_sim(torch, "ibert", dev),
                                           deit_small_patch16_224, "ibert",
                                           ("attn_block", "mlp_block")),
                "swin_tiny_patch4_window7_224": (
                    swin_tiny_patch4_window7_224(gelu_type="ivit", softmax_type="ivit",
                                                 layernorm_type="ivit", device=dev,
                                                 seed=QAT_SEED, drop_path_rate=0.0),
                    swin_tiny_patch4_window7_224, "ivit",
                    ("swin_attn_block", "mlp_block"))}
        ckpts = {}
        t0 = lap("build_sims", t_phase)
        for name, (sim, factory, fam, kernels) in sims.items():
            with torch.no_grad():
                for xb in calib:
                    sim(xb.to(dev), running_stat=True)
            kw = {"drop_path_rate": 0.0} if name.startswith("swin") else {}
            fresh = factory(gelu_type=fam, softmax_type=fam, layernorm_type=fam,
                            device=dev, seed=QAT_SEED + 1, **kw)
            ckpts[name], out[f"round_trip_{name}"] = compat_round_trip(
                torch, counters, dev, name, sim, fresh, images, tmp, fam, kernels)
            for k in kernels:
                rows[k][f"launches_compat_{name.split('_')[0]}"] = 12
            del sim, fresh
            t0 = lap(f"round_trip_{name}", t0)
        torch.cuda.empty_cache()

        # (b) the inference CLI on the DeiT-S checkpoint
        deit = ckpts["deit_small_patch16_224"]
        eng_path, io_path = os.path.join(tmp, "eng.npz"), os.path.join(tmp, "io.csv")
        argv = ["--weights", deit, "--dataset", "synthetic", "--batch-size",
                str(COMPAT_CLI_BATCH), "--max-batches", str(COMPAT_CLI_BATCHES),
                "--calibration-batches", "1", "--export-engine", eng_path,
                "--io-stats", io_path, "--device", "cuda"]
        result, launches = run_counted(torch, counters, lambda: inference.main(argv))
        t0 = lap("inference_cli", t0)
        expect = {k: 12 * COMPAT_CLI_BATCHES if k in ("attn_block", "mlp_block") else 0
                  for k in counters}
        expect["ln_requant"] = COMPAT_CLI_BATCHES
        if launches != expect or result["images"] != COMPAT_CLI_BATCH * COMPAT_CLI_BATCHES:
            raise AssertionError(f"inference CLI launched {launches}, want {expect} "
                                 f"({result['images']} images)")
        for k in ("attn_block", "mlp_block"):
            rows[k]["launches_inference_cli"] = launches[k]
        # the artifact == the sim recalibrated on the CLI's calibration batch
        sim = deit_small_patch16_224(gelu_type="ibert", softmax_type="ibert",
                                     layernorm_type="ibert", device=dev, seed=QAT_SEED + 2)
        load_into_model(sim, deit)
        cal = SyntheticDataset(n=8 * COMPAT_CLI_BATCH, seed=2)
        xb = next(data_loader(cal, COMPAT_CLI_BATCH, train=True, img_size=224))["image"]
        ds = SyntheticDataset(n=8 * COMPAT_CLI_BATCH, seed=1)
        x0 = next(data_loader(ds, COMPAT_CLI_BATCH, train=False, img_size=224,
                              drop_last=True))["image"]
        x0 = torch.from_numpy(x0).to(dev)
        with torch.no_grad():
            sim(torch.from_numpy(xb).to(dev), running_stat=True)
            want = sim(x0)
        spec = load_engine(eng_path)
        eng = Engine(spec)
        got = eng(x0)
        if not torch.equal(got, want):
            raise AssertionError("inference CLI: the exported artifact's Engine != the "
                                 "recalibrated sim: max abs diff "
                                 f"{(got - want).abs().max().item()}")
        # the IO-stats CSV: one row per (tensor, scale) site, the CPU's set
        with open(io_path) as f:
            csv_layers = [line.split(",", 1)[0] for line in f.read().splitlines()[1:]]
        t0 = lap("recalibrated_sim", t0)
        cpu_sim = copy.deepcopy(sim).cpu()
        clear_io_stats()
        attach_io_stats(cpu_sim)(x0[:1].cpu())
        cpu_layers = [r["layer"] for r in get_io_stats()]
        clear_io_stats()
        if csv_layers != cpu_layers:
            raise AssertionError(f"inference CLI: IO-stats rows {len(csv_layers)} != the "
                                 f"CPU's {len(cpu_layers)}")
        del sim, cpu_sim
        out["inference_cli"] = {**result, "io_stats_rows": len(csv_layers),
                                "artifact_equal_sim": True, "nvidia_smi": smi}
        t0 = lap("io_stats_cpu", t0)
        n_cli = result["images"]
        cli_counts = [round(result[k] * n_cli) for k in ("top1", "top5")]

        # (c) engine_inference on the artifact, plain and served
        argv = ["--engine", eng_path, "--dataset", "synthetic", "--device", "cuda"]
        plain = engine_inference.main(argv + ["--batch-size", str(COMPAT_CLI_BATCH),
                                              "--max-batches", str(COMPAT_CLI_BATCHES)])
        if [round(plain[k] * plain["images"]) for k in ("top1", "top5")] != cli_counts \
                or plain["images"] != n_cli:
            raise AssertionError(f"engine_inference counts {plain} != the inference "
                                 f"CLI's {result}")
        served = engine_inference.main(argv + [
            "--batch-size", str(COMPAT_SERVE_BATCH), "--max-batches",
            str(COMPAT_SERVE_BATCHES), "--serve"])
        n_served = COMPAT_SERVE_BATCH * COMPAT_SERVE_BATCHES
        ds = SyntheticDataset(n=8 * COMPAT_SERVE_BATCH, seed=1)
        batches = [b for _, b in zip(range(COMPAT_SERVE_BATCHES),
                                     data_loader(ds, COMPAT_SERVE_BATCH, train=False,
                                                 img_size=224, drop_last=True))]
        x = np.concatenate([b["image"] for b in batches])
        labels = np.concatenate([b["label"] for b in batches])
        want = eng(torch.from_numpy(x)).cpu().numpy()
        if served["images"] != n_served or \
                [round(served[k] * n_served) for k in ("top1", "top5")] != \
                topk_counts(np, want, labels):
            raise AssertionError(f"engine_inference --serve: {served} != Engine(spec)'s "
                                 "counts")
        with ServingEngine(spec, batch_size=COMPAT_SERVE_BATCH) as srv:
            answers = srv.infer(x[:2 * COMPAT_SERVE_BATCH])
        if not np.array_equal(answers, want[:2 * COMPAT_SERVE_BATCH]):
            raise AssertionError("served answers != Engine(spec)'s")
        out["engine_inference"] = {"plain": plain, "served": served,
                                   "counts_equal_cli": True, "served_bitwise": True}
        del eng, spec
        t0 = lap("engine_inference", t0)

        # (d) serving_bench
        bench_out = os.path.join(tmp, "serving.json")
        bench = serving_bench.main(["--out", bench_out, "--requests", str(COMPAT_REQUESTS),
                                    "--batches", COMPAT_BENCH_BATCHES, "--device", "cuda"])
        t0 = lap("serving_bench", t0)
        with open(bench_out) as f:
            written = json.load(f)
        keys = {"model", "families", "card", "device", "requests_per_point", "points",
                "raw_engine_b64_img_s", "path_choice", "overload_ab"}
        if set(written) != keys or any(p["served"] + p["rejected"] + p["shed"]
                                       != p["offered"] for p in written["overload_ab"]):
            raise AssertionError(f"serving_bench: keys {sorted(written)}, overload "
                                 f"{written['overload_ab']}")
        out["serving_bench"] = {"requests_per_point": COMPAT_REQUESTS,
                                "raw_engine_b64_img_s": bench["raw_engine_b64_img_s"],
                                "points": [{k: p[k] for k in (
                                    "batch_size", "throughput_img_s", "latency_ms_p50",
                                    "latency_ms_p95", "latency_ms_p99")}
                                    for p in bench["points"]],
                                "overload_ab": [{k: p[k] for k in (
                                    "mode", "offered", "served", "rejected", "shed",
                                    "latency_ms_p95")} for p in bench["overload_ab"]]}

        # (e) the envelope audit, card and CPU, and the taps' cost
        table = io.StringIO()        # the CLI's per-site tables, kept off the log
        with contextlib.redirect_stdout(table):
            recs, bad = analyze_io_stats.engine_audit("deit_small_patch16_224",
                                                      "ibert,ibert,ibert", 4, "cuda")
            t0 = lap("audit_card", t0)
            cpu_recs, _ = analyze_io_stats.engine_audit("deit_small_patch16_224",
                                                        "ibert,ibert,ibert", 4, "cpu")
            t0 = lap("audit_cpu", t0)
        if bad or recs != cpu_recs or len(recs) < 100:
            raise AssertionError(f"audit: {len(bad)} hard violations, card records == "
                                 f"CPU's: {recs == cpu_recs} ({len(recs)} sites)")
        gen_x = torch.Generator(device=dev).manual_seed(0)
        batches = [torch.randn((BATCH, 224, 224, 3), generator=gen_x, device=dev)
                   for _ in range(3)]
        fused = Engine(synthetic_spec(deit_small_config(), seed=0))
        out["audit"] = {"sites": len(recs), "hard_violations": 0, "equal_cpu": True,
                        "max_sat_frac": max(r.get("sat_frac", 0.0) for r in recs),
                        "fused_img_per_s_no_capture": img_per_s(torch, fused, batches, 6),
                        "engine_phase_img_per_s": engine_img_s}
        del fused, batches
        t0 = lap("taps_idle_img_s", t0)

        # (f) the training CLI from a timm-style float file
        fm = float_model("deit_small_patch16_224", device="cpu", seed=QAT_SEED + 3)
        timm = os.path.join(tmp, "deit_small_timm.pth")
        torch.save({"model": timm_state_dict(fm)}, timm)
        del fm
        runs = os.path.join(tmp, "runs")
        trainer = quant_train.build_trainer(quant_train.parse_args([
            "--model", "deit_small_patch16_224", "--dataset", "synthetic",
            "--synthetic-samples", str(COMPAT_TRAIN_SAMPLES), "--batch-size",
            str(COMPAT_TRAIN_BATCH), "--epochs", "1", "--calibration-batches", "1",
            "--num-classes", "1000", "--seed", str(QAT_SEED), "--output-dir", runs,
            "--run-id", "compat",
            "--log-interval", "1", "--pretrained", timm, "--device", "cuda"]))
        params_in, _ = convert_state_dict(load_torch_checkpoint(timm)[0])
        bad = differing_leaves(variables_to_numpy(trainer.model)["params"], params_in)
        if bad:
            raise AssertionError(f"quant_train --pretrained: parameters differ from the "
                                 f"file's at {bad[:5]}")
        t0 = lap("pretrained_build", t0)
        trainer.fit()
        fit_s = time.perf_counter() - t0
        with open(os.path.join(runs, "log_compat.jsonl")) as f:
            losses = [r["loss"] for r in map(json.loads, f) if r["phase"] == "train"]
        if len(losses) != COMPAT_TRAIN_SAMPLES // COMPAT_TRAIN_BATCH \
                or not np.isfinite(losses).all():
            raise AssertionError(f"quant_train --pretrained: losses {losses}")
        out["pretrained_train"] = {"tensors_in_file": len(load_torch_checkpoint(timm)[0]),
                                   "params_equal_file": True, "losses": losses,
                                   "fit_s": fit_s}
        del trainer
        torch.cuda.empty_cache()
        lap("pretrained_fit", t0)
    out["seconds"] = time.perf_counter() - t_phase
    out["step_seconds"] = step_s
    emit({"phase": "compat_cli", "nvidia_smi": smi,
          "config": "deit_small_patch16_224 ibert / swin_tiny_patch4_window7_224 ivit "
                    "224px full depth, seed 0; calibration 2 x 8 images; CLIs at batch "
                    f"256 x 4, served at 64 x 8, serving_bench {COMPAT_REQUESTS} requests "
                    "a point (its default 2,048)", **out})
    if out["seconds"] > 90:
        raise AssertionError(f"compat_cli took {out['seconds']:.1f} s (budget 90 s)")


# ---------------------------------------------------------------------------
# Phase 26: parallelism on the card
# ---------------------------------------------------------------------------

PAR_BATCH = 64            # the engines' global batch (32 a rank under dp 2)
PAR_SIM_BATCH = 16        # the tp sim forwards and the dp train step
PAR_SERVED = 512          # requests through each server
PAR_TIMEOUT = 300         # seconds a spawned world may take


def _par_counters():
    from ivit_tpu_torch.ops.kernels import block as kb
    from ivit_tpu_torch.ops.kernels import nonlinear as knl
    return {"attn_block": kb.attn_block, "mlp_block": kb.mlp_block,
            "swin_attn_block": kb.swin_attn_block, "shiftmax": knl.shiftmax,
            "shift_gelu_requant": knl.shift_gelu_requant, "ln_requant": knl.ln_requant}


def _par_images(np, n, img=224, seed=QAT_SEED + 31):
    return np.random.default_rng(seed).normal(size=(n, img, img, 3)).astype(np.float32)


def _par_collectives(coll, forwards=1):
    """Each collective's count and ms per forward (host clock, the card
    synchronized around each: gloo's host staging included)."""
    return {k: {"count": v["count"] / forwards, "ms": v["ms"] / forwards}
            for k, v in sorted(coll.STATS.items())}


def _par_counted_forward(torch, coll, fn):
    """A warm-up call, then ``fn`` with every launch count and collective
    statistic set to 0 just before it (collectives timed); returns its
    result, the counts and the collectives."""
    fn()
    counters = _par_counters()
    for c in counters.values():
        c.launches = 0
    coll.reset_stats()
    torch.cuda.synchronize()
    with coll.timed():
        out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}, _par_collectives(coll)


def _par_pair_rank(rank):
    """One of two gloo ranks on cuda:0: the dp-2 fused engine, the tp-2
    standalone-kernel engine, the tp-2 DeiT-S ivit sim, a dp-2 train step;
    each against the single-device run in this process."""
    import copy

    import numpy as np
    import torch

    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.convert import params_to_torch
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
    from ivit_tpu_torch.engine.vit_int import engine_forward
    from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
    from ivit_tpu_torch.ops.kernels import nonlinear as knl
    from ivit_tpu_torch.parallel import (collectives as coll, local_rows, make_mesh,
                                         shard_engine_params, shard_module)
    from ivit_tpu_torch.parallel.launch import rank_device
    from ivit_tpu_torch.train import optim
    from ivit_tpu_torch.train.steps import init_train_state, make_train_step

    dev = rank_device()
    out = {}
    x = _par_images(np, PAR_BATCH)
    xd = torch.from_numpy(x).to(dev)

    # dp 2: the fused block kernels on this rank's 32 rows
    spec = synthetic_spec(deit_small_config(), seed=0)
    want = Engine(spec)(xd)
    mesh = make_mesh(2, 1)
    local = type(spec)(spec.config, params_to_torch(spec.params, dev))
    got, launches, colls = _par_counted_forward(torch, coll, lambda: engine_forward(
        local, local_rows(xd, mesh), kernels=True, mesh=mesh))
    if not torch.equal(got, want):
        raise AssertionError(f"rank {rank}: dp-2 engine != Engine(spec): max abs "
                             f"{(got - want).abs().max().item()}")
    out["engine_dp"] = {"launches": launches, "collectives": colls,
                        "rows": PAR_BATCH // 2}

    # tp 2: the standalone kernels on this rank's 3 heads and 768 columns
    spec = synthetic_spec(deit_small_config(ln="ivit", gelu="ivit", softmax="ivit"),
                          seed=0)
    want = Engine(spec, kernels="ops")(xd)
    mesh = make_mesh(1, 2)
    shards, _ = shard_engine_params(spec.params, mesh)
    local = type(spec)(spec.config, params_to_torch(shards, dev))
    shapes = {"shiftmax": set(), "shift_gelu_requant": set()}
    originals = {k: getattr(knl, k) for k in shapes}

    def recorder(name):
        # the wrapper counts in the name it is bound to: this one's, while
        # it stands in for it
        def call(x, *a, **k):
            shapes[name].add(tuple(x.shape))
            return originals[name](x, *a, **k)
        call.launches = 0
        return call
    try:
        for k in shapes:
            setattr(knl, k, recorder(k))
        got, launches, colls = _par_counted_forward(torch, coll, lambda: engine_forward(
            local, xd, kernels="ops", mesh=mesh))
    finally:
        for k, f in originals.items():
            setattr(knl, k, f)
    if not torch.equal(got, want):
        raise AssertionError(f"rank {rank}: tp-2 engine != Engine(spec, 'ops'): max "
                             f"abs {(got - want).abs().max().item()}")
    out["engine_tp"] = {"launches": launches, "collectives": colls,
                        "shapes": {k: sorted(v) for k, v in shapes.items()}}

    # tp 2: the DeiT-S ivit sim (qkv x QAT_QKV_GAIN), calibrated on the card
    sim = qat_sim(torch, "ivit", dev)
    rng = np.random.default_rng(QAT_SEED + 32)
    with torch.no_grad():
        for _ in range(QAT_CALIB):
            sim(torch.from_numpy(rng.normal(size=(QAT_CALIB_BATCH, 224, 224, 3))
                                 .astype(np.float32)).to(dev), running_stat=True)
        xs = xd[:PAR_SIM_BATCH]
        want = sim(xs)
        t0 = time.perf_counter()
        got = shard_module(copy.deepcopy(sim), mesh)(xs)
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"rank {rank}: tp-2 sim != single-device sim: max abs "
                             f"{(got - want).abs().max().item()}")
    out["sim_tp"] = {"first_forward_s": time.perf_counter() - t0}

    # dp 2: one train step on a global batch of 16 (drop-path 0.1)
    from ivit_tpu_torch.models import deit_small_patch16_224
    sim = deit_small_patch16_224(drop_path_rate=0.1, device="cpu", seed=QAT_SEED).to(dev)
    with torch.no_grad():
        sim(xd[PAR_SIM_BATCH:2 * PAR_SIM_BATCH], running_stat=True)
    tx = optim.chain(optim.clip_by_global_norm(1.0),
                     optim.scale_by_learning_rate(lambda c: np.float32(1e-3)))
    batch = {"image": xd[:PAR_SIM_BATCH],
             "label": torch.arange(PAR_SIM_BATCH, device=dev) * 37 % 1000}
    ref = copy.deepcopy(sim)
    ref_state, ref_m = make_train_step(ref, tx, 1000, log_grad_norm=True)(
        init_train_state(ref, tx), batch, torch.Generator().manual_seed(5))
    shard_module(sim, make_mesh(2, 1))
    t0 = time.perf_counter()
    state, m = make_train_step(sim, tx, 1000, log_grad_norm=True)(
        init_train_state(sim, tx), batch, torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    a, b = variables_to_numpy(sim), variables_to_numpy(ref)
    if differing_leaves(a["quant_stats"], b["quant_stats"]):
        raise AssertionError(f"rank {rank}: dp-2 step quant_stats differ")
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    worst = 0.0
    for (pa, ga), (_, gb) in zip(optim.tree_paths(a["params"]),
                                 optim.tree_paths(b["params"])):
        np.testing.assert_allclose(ga, gb, rtol=2e-4, atol=2e-6, err_msg=str(pa))
        worst = max(worst, float(np.abs(ga - gb).max()))
    out["train_dp"] = {"loss": float(m["loss"]), "loss_single": float(ref_m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "grad_norm_single": float(ref_m["grad_norm"]),
                       "max_param_abs_diff": worst, "step_s": step_s}
    return out


def _par_swin_rank(rank):
    """One of three gloo ranks on cuda:0: the Swin-T ivit sim at tp 3
    (heads 1/2/4/8 a rank) against the single-device sim; the synthetic
    Swin-T ivit engine at dp 3 on the fused kernels (2 rows a rank) and at
    tp 3 on the plain path, against the single-device ``Engine``."""
    import copy

    import numpy as np
    import torch

    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.convert import params_to_torch
    from ivit_tpu_torch.engine.swin_int import swin_engine_forward
    from ivit_tpu_torch.engine.synthetic import swin_tiny_config, synthetic_swin_spec
    from ivit_tpu_torch.models import swin_tiny_patch4_window7_224
    from ivit_tpu_torch.parallel import (local_rows, make_mesh, shard_engine_params,
                                         shard_module)
    from ivit_tpu_torch.parallel.launch import rank_device

    dev = rank_device()
    out = {}
    spec = synthetic_swin_spec(swin_tiny_config(), seed=0)
    xe = torch.from_numpy(_par_images(np, 6, seed=QAT_SEED + 36)).to(dev)
    for name, (dp, tp), kernels in (("engine_dp3", (3, 1), True),
                                    ("engine_tp3", (1, 3), False)):
        mesh = make_mesh(dp, tp)
        want = Engine(spec, kernels=kernels)(xe)
        local, _ = shard_engine_params(spec.params, mesh)
        lspec = type(spec)(spec.config, params_to_torch(local, dev))
        counters = _par_counters()
        for c in counters.values():
            c.launches = 0
        got = swin_engine_forward(lspec, local_rows(xe, mesh), kernels=kernels,
                                  mesh=mesh)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"rank {rank}: Swin-T {name} != Engine(spec)")
        out[name] = {k: c.launches for k, c in counters.items()}
    sim = swin_tiny_patch4_window7_224(device="cpu", seed=QAT_SEED).to(dev)
    x = torch.from_numpy(_par_images(np, 8, seed=QAT_SEED + 33)).to(dev)
    with torch.no_grad():
        sim(x[4:], running_stat=True)
        want = sim(x[:4])
        tp = shard_module(copy.deepcopy(sim), make_mesh(1, 3))
        got = tp(x[:4])
    if not torch.equal(got, want):
        raise AssertionError(f"rank {rank}: tp-3 Swin-T sim != single-device sim")
    out["heads"] = [tp.stages[i][0][0].attn.relative_position_bias_table.shape[1]
                    for i in range(4)]
    return out


def _par_cli_folder(root):
    """A seeded 2-class ImageFolder of 16 train and 16 val PNGs."""
    import numpy as np
    rng = np.random.default_rng(QAT_SEED + 34)
    for split in ("train", "val"):
        for c in range(2):
            cdir = os.path.join(root, split, f"class_{c}")
            os.makedirs(cdir, exist_ok=True)
            for k in range(8):
                write_png(os.path.join(cdir, f"img_{k}.png"),
                          rng.integers(0, 256, (96, 96, 3)).astype(np.uint8))


def parallel_phase(torch, counters, dev, rows, smi):
    """Phase 26: parallelism on the card (one card).  (a) A world of one on
    NCCL, in this process: the dp 1 x tp 1 mesh's DeiT-S ibert engine
    (batch 64, the fused kernels) bitwise Engine(spec)'s, 12 + 12
    launches and its final norm's ``ln_requant``; an NCCL int32 all_reduce
    of values past 2**24, exact.  (b) Two gloo ranks on cuda:0 (spawned;
    NCCL refuses two ranks on one device): the dp-2 fused engine (32 rows a
    rank, 12 + 12 + 1 launches), the tp-2 ivit engine on the standalone
    kernels (3 heads and 768 + 16 columns a rank, 12 + 12 + 1 launches),
    each bitwise the single-device
    Engine's; the tp-2 DeiT-S ivit sim (qkv x QAT_QKV_GAIN) bitwise the
    single-device sim; one dp-2 train step on a global batch of 16:
    quant_stats bitwise, the loss within rtol 1e-5 and the params within
    rtol 2e-4 / atol 2e-6 (tests/test_parallel.py's bounds).  (c) Three
    gloo ranks: the Swin-T ivit sim at tp 3, bitwise; the synthetic Swin-T
    engine at dp 3 (fused, 12 + 12 + 5 launches a rank) and tp 3 (plain,
    none), bitwise.  (d) ServingEngine
    over devices ["cuda:0", "cuda:0"]: every answer bitwise Engine(spec)'s,
    24 + 24 + 2 launches a served batch, its img/s beside a one-replica
    server's.  (e) quant_train --mesh-dp 1 --mesh-tp 1 on a seeded folder
    (one spawned rank on NCCL, one step), and the --mesh-dp 2 refusal."""
    import json
    import shutil
    import tempfile

    import numpy as np

    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.serving import ServingEngine
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
    from ivit_tpu_torch.engine.vit_int import engine_forward
    from ivit_tpu_torch.parallel import collectives as coll
    from ivit_tpu_torch.parallel import launch, make_mesh
    from ivit_tpu_torch.scripts import quant_train

    t_phase = time.perf_counter()
    out, step_s = {}, {}
    tmp = tempfile.mkdtemp(prefix="ivit_parallel_")
    try:
        # (a) a world of one on NCCL
        t0 = time.perf_counter()
        launch.init_process_group(0, 1, "nccl", dev, f"file://{tmp}/rendezvous")
        try:
            spec = synthetic_spec(deit_small_config(), seed=0)
            eng = Engine(spec)
            x = torch.from_numpy(_par_images(np, PAR_BATCH)).to(dev)
            want = eng(x)
            mesh = make_mesh(1, 1)
            got, launches = run_counted(torch, counters, lambda: engine_forward(
                eng._spec, x, kernels=True, mesh=mesh))
            check_logits(torch, "parallel world-of-one engine", got, want, 1000,
                         PAR_BATCH)
            if (launches["attn_block"], launches["mlp_block"], launches["ln_requant"]) != \
                    (12, 12, 1):
                raise AssertionError(f"world of one: launches {launches}")
            big = torch.tensor([2**24 + 1, -(2**30) - 3, 2**31 - 1], dtype=torch.int32,
                               device=dev)
            red = big.clone()
            torch.distributed.all_reduce(red)
            if not torch.equal(red, big):
                raise AssertionError(f"NCCL int32 all_reduce: {red.tolist()}")
            out["world_of_one"] = {"launches": launches, "backend":
                                   torch.distributed.get_backend()}
        finally:
            torch.distributed.destroy_process_group()
        t0 = lap(step_s, "world_of_one", t0)

        # (b) two gloo ranks on cuda:0
        pair = launch.spawn(_par_pair_rank, 2, backend="gloo",
                            devices=["cuda:0", "cuda:0"], timeout=PAR_TIMEOUT)
        for r, res in enumerate(pair):
            dp_l, tp_l = res["engine_dp"]["launches"], res["engine_tp"]["launches"]
            if (dp_l["attn_block"], dp_l["mlp_block"], dp_l["ln_requant"]) != (12, 12, 1):
                raise AssertionError(f"rank {r}: dp-2 launches {dp_l}")
            if (tp_l["shiftmax"], tp_l["shift_gelu_requant"], tp_l["ln_requant"]) != \
                    (12, 12, 1):
                raise AssertionError(f"rank {r}: tp-2 launches {tp_l}")
            shapes = res["engine_tp"]["shapes"]
            if shapes["shiftmax"] != [(PAR_BATCH, 3, 197, 197)] or \
                    shapes["shift_gelu_requant"] != [(PAR_BATCH, 197, 768 + 16)]:
                raise AssertionError(f"rank {r}: tp-2 kernel shapes {shapes}")
        out["pair"] = pair
        t0 = lap(step_s, "two_ranks", t0)

        # (c) three gloo ranks: Swin-T at tp 3
        trio = launch.spawn(_par_swin_rank, 3, backend="gloo",
                            devices=["cuda:0"] * 3, timeout=PAR_TIMEOUT)
        for r, t in enumerate(trio):
            d3, t3 = t["engine_dp3"], t["engine_tp3"]
            if t["heads"] != [1, 2, 4, 8] or \
                    (d3["swin_attn_block"], d3["mlp_block"], d3["ln_requant"]) != (12, 12, 5) or \
                    t3["swin_attn_block"] + t3["mlp_block"] + t3["ln_requant"] != 0:
                raise AssertionError(f"rank {r}: tp-3 Swin-T heads / launches {t}")
        out["swin_trio"] = trio[0]
        t0 = lap(step_s, "three_ranks", t0)

        # (d) the server over two replicas on cuda:0
        images = _par_images(np, PAR_SERVED, seed=QAT_SEED + 35)
        want = np.concatenate([eng(torch.from_numpy(images[i:i + PAR_BATCH]).to(dev))
                               .cpu().numpy() for i in range(0, PAR_SERVED, PAR_BATCH)])
        served = {}
        for name, kw in (("one_replica", {}), ("two_replicas",
                                                {"devices": ["cuda:0", "cuda:0"]})):
            with ServingEngine(spec, batch_size=PAR_BATCH, max_wait_ms=5, **kw) as srv:
                srv.infer(images[:PAR_BATCH])            # warm-up batch
                srv.metrics = type(srv.metrics)()
                t1 = time.perf_counter()
                got, launches = run_counted(torch, counters,
                                            lambda: srv.infer(images))
                wall = time.perf_counter() - t1
                batches = srv.metrics.summary()["batches"]
            if not np.array_equal(got, want):
                raise AssertionError(f"{name} server != Engine(spec)")
            served[name] = {"img_s": PAR_SERVED / wall, "batches": batches,
                            "launches_per_batch": {k: launches[k] / batches for k in (
                                "attn_block", "mlp_block", "ln_requant")}}
        if served["two_replicas"]["launches_per_batch"] != {"attn_block": 24,
                                                            "mlp_block": 24,
                                                            "ln_requant": 2}:
            raise AssertionError(f"two-replica server launches {served}")
        out["serving"] = served
        t0 = lap(step_s, "serving", t0)

        # (e) the CLI's mesh path: one spawned rank on NCCL, one step
        root = os.path.join(tmp, "folder")
        _par_cli_folder(root)
        argv = ["--model", "deit_small_patch16_224", "--data-path", root,
                "--batch-size", "16", "--epochs", "1", "--calibration-batches", "1",
                "--aa", "none", "--seed", str(QAT_SEED), "--output-dir",
                os.path.join(tmp, "runs"), "--run-id", "mesh", "--log-interval", "1"]
        best = quant_train.main(argv + ["--mesh-dp", "1", "--mesh-tp", "1"])
        with open(os.path.join(tmp, "runs", "log_mesh.jsonl")) as f:
            losses = [r["loss"] for r in map(json.loads, f) if r["phase"] == "train"]
        if len(losses) != 1 or not np.isfinite(losses).all():
            raise AssertionError(f"quant_train --mesh-dp 1: losses {losses}")
        if not os.path.exists(os.path.join(tmp, "runs", "checkpoint_mesh",
                                           "state.msgpack")):
            raise AssertionError("quant_train --mesh-dp 1 wrote no checkpoint")
        try:
            quant_train.main(argv + ["--mesh-dp", "2"])
        except RuntimeError as e:
            if "spawns 2 processes" not in str(e):
                raise
            refusal = str(e)
        else:
            raise AssertionError("quant_train --mesh-dp 2 ran on one card")
        out["cli"] = {"best_acc1": best, "loss": losses[0], "refusal": refusal}
        lap(step_s, "cli", t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in ("attn_block", "mlp_block"):
        rows[k]["launches_parallel_dp_rank"] = pair[0]["engine_dp"]["launches"][k]
        rows[k]["launches_served_batch_2_replicas"] = \
            out["serving"]["two_replicas"]["launches_per_batch"][k]
    for k in ("shiftmax", "shift_gelu_requant"):
        rows[k]["launches_parallel_tp_rank"] = pair[0]["engine_tp"]["launches"][k]
    rows["swin_attn_block"]["launches_parallel_dp3_rank"] = \
        trio[0]["engine_dp3"]["swin_attn_block"]
    rows["mlp_block"]["launches_parallel_swin_dp3_rank"] = trio[0]["engine_dp3"]["mlp_block"]
    seconds = time.perf_counter() - t_phase
    emit({"phase": "parallel", "seconds": seconds, "step_s": step_s,
          "nvidia_smi": smi, **out})
    if seconds > 90:
        raise AssertionError(f"parallel phase took {seconds:.1f} s (budget 90 s)")


# ---------------------------------------------------------------------------
# Phase 27: the ports of the JAX package's root scripts
# ---------------------------------------------------------------------------

SCRIPTS_TIMEOUT = 300     # seconds a spawned world may take
# JAX's scripts/sweep.py --dry-run on sweep.yaml: its points in its order
SWEEP_RUN_IDS = [f"bitwidth-{b}_layer-type-{f}" for b in ("8", "8.8.8.8.16.8.16.8")
                 for f in ("ivit", "ibert", "ppoly", "float")]
APPROX_FAMILIES = ["ivit", "ibert", "ppoly", "ibert_int_sqrt"]


def scripts_phase(torch, counters, dev, rows, smi):
    """Phase 27: the root scripts' ports.  (a) ``scaling_bench.measure`` on
    DeiT-S ibert (``build_spec``: full depth and width, 224 px, qkv x
    ``QAT_QKV_GAIN``, calibrated on the card and frozen), weak, 32 images a rank, 10 timed forwards: width 1 a world of
    one on NCCL, width 2 two gloo ranks on ``cuda:0``, each with its server;
    every rank's gathered logits and every served answer bitwise
    ``Engine(spec)``'s, 12 + 12 fused launches a rank a forward.  (b)
    ``approx_analysis``, the four functions and families, on the card and
    the CPU: outputs bitwise, statistics equal.  (c) ``ppoly_sweep``'s 2 x
    2 grid, both backends and functions: the card's rows the CPU's.  (d)
    ``sweep``: the dry run on ``sweep.yaml`` gives JAX's 8 points in JAX's
    order (through PyYAML where it imports and through the port's own
    reader); one point (ivit, bitwidth 8) trains on the card through
    ``quant_train``: return code 0 and a final epoch record."""
    import shutil
    import tempfile

    import numpy as np

    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.scripts import approx_analysis, ppoly_sweep, scaling_bench, sweep

    t_phase = time.perf_counter()
    out, step_s = {}, {}

    # (a) scaling_bench at widths 1 (NCCL) and 2 (gloo, cuda:0 twice), on
    # the script's spec with qkv x QAT_QKV_GAIN (at the init's scale the
    # logits do not depend on the image: a bitwise match would say little)
    t0 = time.perf_counter()
    import ivit_tpu_torch.models as models
    registry = models.str2model

    def gained(name):
        build = registry(name)

        def sim(**kw):
            model = build(**kw)
            with torch.no_grad():
                for blk in model.blocks:
                    blk.attn.qkv.kernel.mul_(QAT_QKV_GAIN)
            return model
        return sim
    models.str2model = gained
    try:
        spec = scaling_bench.build_spec("deit_small_patch16_224", "ibert", dev)
    finally:
        models.str2model = registry
    devices = ["cuda:0", "cuda:0"]
    for c in counters.values():
        c.launches = 0
    results, runs = scaling_bench.measure(spec, [1, 2], devices=devices,
                                          per_device_batch=32, iters=10,
                                          serving=True, timeout=SCRIPTS_TIMEOUT)
    torch.cuda.synchronize()
    served_launches = {k: c.launches for k, c in counters.items()}
    eng = Engine(spec)
    widths = []
    for rec, run in zip(results, runs):
        w = rec["devices"]
        want = eng(torch.from_numpy(run["images"]).to(dev))
        for r in run["ranks"]:
            got = torch.from_numpy(r["logits"]).to(dev)
            check_logits(torch, f"scaling_bench width {w} rank {r['rank']}", got,
                         want, 1000, rec["batch"])
            if (r["launches"]["attn_block"], r["launches"]["mlp_block"]) != (12, 12):
                raise AssertionError(f"scaling_bench width {w} rank {r['rank']}: "
                                     f"launches {r['launches']}")
        one = eng(torch.from_numpy(run["served_images"]).to(dev)).cpu().numpy()
        if not np.array_equal(run["served"], np.concatenate([one, one])):
            raise AssertionError(f"scaling_bench width {w}: served != Engine(spec)")
        widths.append({"width": w, "backend": run["backend"], "devices": run["devices"],
                       "ranks": [{k: r[k] for k in ("rank", "seconds", "launches")}
                                 | {"all_gather_ms": r["collectives"].get(
                                     "all_gather", {}).get("ms")}
                                 for r in run["ranks"]]})
    artifact = scaling_bench.make_artifact(
        "weak", torch.cuda.get_device_name(0), "deit_small_patch16_224", "ibert",
        results, scaling_bench.shares_silicon(devices))
    out["scaling_bench"] = {"artifact": artifact, "widths": widths,
                            "served_launches_in_this_process": served_launches}
    t0 = lap(step_s, "scaling_bench", t0)

    # (b) approx_analysis on the card and on the CPU (the statistics from
    # the same outputs, as analyze() takes them: a GELU call fits a table)
    approx = {}
    for fn in approx_analysis.FUNCTIONS:
        card, ref = approx_analysis.outputs(fn, 0.05, APPROX_FAMILIES, dev)
        host, _ = approx_analysis.outputs(fn, 0.05, APPROX_FAMILIES, "cpu")
        if list(card) != list(host):
            raise AssertionError(f"approx_analysis {fn}: families {list(card)}")
        for fam in card:
            if not np.array_equal(card[fam], host[fam]):
                raise AssertionError(f"approx_analysis {fn} {fam}: card != CPU, "
                                     f"{int((card[fam] != host[fam]).sum())} outputs")
        stats = {fam: approx_analysis._err_stats(y, ref) for fam, y in card.items()}
        if stats != {fam: approx_analysis._err_stats(y, ref) for fam, y in host.items()}:
            raise AssertionError(f"approx_analysis {fn}: statistics differ")
        approx[fn] = stats
    out["approx_analysis"] = approx
    t0 = lap(step_s, "approx_analysis", t0)

    # (c) ppoly_sweep's 2 x 2 grid on the card and on the CPU (the scripts'
    # own lines go to stderr: stdout carries the smoke's JSON lines)
    sweeps = {}
    for fn in ("gelu", "softmax"):
        grid = (fn, 0.05, [1, 2], [8, 16], [22], ["float", "ibert"], False)
        with contextlib.redirect_stdout(sys.stderr):
            card_rows = ppoly_sweep.sweep(*grid, device=dev)
            cpu_rows = ppoly_sweep.sweep(*grid, device="cpu")
        if card_rows != cpu_rows:
            raise AssertionError(f"ppoly_sweep {fn}: card rows != CPU rows")
        sweeps[fn] = [{k: r[k] for k in ("deg", "seg", "backend", "max_err")}
                      for r in card_rows]
    out["ppoly_sweep"] = sweeps
    t0 = lap(step_s, "ppoly_sweep", t0)

    # (d) sweep: JAX's points; one point trained on the card
    tmp = tempfile.mkdtemp(prefix="ivit_sweep_")
    try:
        cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sweep.yaml")
        with contextlib.redirect_stdout(sys.stderr):
            dry = sweep.main(["--config", cfg_path, "--dry-run", "--output-dir",
                              os.path.join(tmp, "dry")])
        with open(cfg_path) as f:
            own = sweep.points(sweep._mini_yaml(f.read()))
        if [r["run_id"] for r in dry] != SWEEP_RUN_IDS or \
                [run_id for _, run_id in own] != SWEEP_RUN_IDS:
            raise AssertionError(f"sweep --dry-run points {[r['run_id'] for r in dry]}")
        one = os.path.join(tmp, "one.yaml")
        with open(one, "w") as f:
            f.write("grid:\n  layer-type:\n    - ivit\n  bitwidth:\n    - 8\n")
        with contextlib.redirect_stdout(sys.stderr):
            rec, = sweep.main(["--config", one, "--output-dir", os.path.join(tmp, "run"),
                               "--device", "cuda", "--extra", "--dataset", "synthetic",
                               "--synthetic-samples", "32", "--batch-size", "16",
                               "--epochs", "1", "--calibration-batches", "1"])
        if rec["returncode"] != 0 or rec.get("final", {}).get("phase") != "epoch" \
                or not np.isfinite(rec["final"]["loss"]):
            raise AssertionError(f"sweep point: {rec}")
        out["sweep"] = {"dry_run_points": len(dry), "point": rec}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lap(step_s, "sweep", t0)

    for k in ("attn_block", "mlp_block"):
        rows[k]["launches_scaling_bench_rank"] = runs[-1]["ranks"][0]["launches"][k]
    emit({"phase": "scripts", "seconds": time.perf_counter() - t_phase,
          "step_s": step_s, "nvidia_smi": smi, **out})


# ---------------------------------------------------------------------------
# Phase 28: the engine's path dispatch on the card's own A/B
# ---------------------------------------------------------------------------

# the ViT table keys at full width and depth: (registry name, family)
DISPATCH_VIT = [("deit_tiny_patch16_224", "ivit"), ("deit_small_patch16_224", "ivit"),
                ("deit_small_patch16_224", "ibert"), ("vit_base_patch16_224", "ivit")]
# path_compare's modes run iters + 2 forwards each (the logits, a warm call,
# the timed calls); cut the iterations, never the widths, depth or batch
DISPATCH_ITERS, DISPATCH_SWIN_ITERS = 5, 10
DISPATCH_SWIN_MODES = ("fused", "attn", "mlp", "stages123", "stages23", "stages3",
                       "unfused", "dispatch")
DISPATCH_MARGIN = 1.10    # a table row's path against the other, in one call


def dispatch_phase(torch, counters, dev, rows, smi):
    """Phase 28: the engine's path dispatch (``engine/dispatch.py``) held
    to this card's own A/B.  (a) ``scripts/path_compare.py``'s modes
    ``blocks`` and ``ops`` on DeiT-T ivit, DeiT-S ivit and ibert and ViT-B
    ivit (the script's spec: the seeded sim calibrated on 8 images and
    frozen; 224 px, full depth, batch 256): both modes bitwise one forward
    of the plain version (``kernels=False``), 12 + 12 block-kernel
    launches a ``blocks`` forward (ivit: 12 + 12 standalone ones an
    ``ops`` forward); ``Engine(spec)`` reports the ``static-table`` row
    and its logits are the ``blocks`` mode's; the row's path not slower
    than the other by more than 10% here; ``Engine(spec, probe_images=x)``
    on DeiT-S reports ``timed-probe`` (ivit) or, where no unfused path
    launches a kernel, skips the probe and keeps the fused kernels
    (ibert), with the same logits.  (b) ``scripts/swin_path_compare.py`` on Swin-T ivit at
    batch 64 (fused, attn, mlp, stages123, stages23, stages3, unfused,
    dispatch; its check): every mode bitwise; ``Engine(spec)`` reports the
    ``swin-stage-table`` stages and the fused logits; each stage row's path
    (the mixes that differ at that stage alone) and the ``("swin", 96)``
    row's not slower than the other by more than 10%."""
    import numpy as np

    from ivit_tpu_torch.engine import Engine, dispatch
    from ivit_tpu_torch.scripts import path_compare, swin_path_compare

    t_phase = time.perf_counter()
    out, launch_rows = {"vit": []}, {}

    def quiet(_line):
        pass

    def slower(name, chosen, other, ms):
        if ms[chosen] > DISPATCH_MARGIN * ms[other]:
            raise AssertionError(f"dispatch {name}: the table's {chosen} "
                                 f"{ms[chosen]} ms > {DISPATCH_MARGIN} x {other} "
                                 f"{ms[other]} ms")

    for model, fam in DISPATCH_VIT:
        name = f"{model} {fam}"
        args = path_compare.parse_args(["--model", model, "--fam", fam,
                                        "--batch", str(BATCH), "--device", "cuda"])
        _, spec, x = path_compare.setup(args)
        cfg = spec.config
        (records, outs), launches = run_counted(torch, counters, lambda: path_compare.compare(
            spec, x, ["blocks", "ops"], DISPATCH_ITERS, emit=quiet))
        # one untimed forward of the plain version, outside the counted run:
        # both kernel modes are held to it at these main-path shapes
        outs["plain"] = Engine(spec, kernels=False)(x).cpu().numpy()
        checks = path_compare.checks(outs, "plain")
        if not all(c["bitwise_equal_vs_plain"] for c in checks):
            raise AssertionError(f"dispatch {name}: modes differ {checks}")
        if not np.isfinite(outs["blocks"]).all():
            raise AssertionError(f"dispatch {name}: non-finite logits")
        per = {k: v / (DISPATCH_ITERS + 2) for k, v in launches.items()}
        want = {"attn_block": cfg.depth, "mlp_block": cfg.depth,
                "shiftmax": cfg.depth if fam == "ivit" else 0,
                "shift_gelu_requant": cfg.depth if fam == "ivit" else 0,
                "ln_requant": ln_norms(cfg, "blocks") + ln_norms(cfg, "ops")}
        if any(per[k] != n for k, n in want.items()):
            raise AssertionError(f"dispatch {name}: launches a forward {per}")
        launch_rows[name] = per
        eng = Engine(spec)
        choice = eng.fusion["path_choice"]
        got = eng(x).cpu().numpy()
        if choice["source"] != "static-table" or not np.array_equal(got, outs["blocks"]):
            raise AssertionError(f"dispatch {name}: Engine(spec) took {choice}, "
                                 f"logits equal: {np.array_equal(got, outs['blocks'])}")
        ms = {r["mode"]: r["ms_per_batch"] for r in records}
        row = dispatch.MEASURED["vit", cfg.embed_dim]
        chosen = "blocks" if row["fused"] else "ops"
        slower(name, chosen, "ops" if row["fused"] else "blocks", ms)
        rec = {"model": model, "fam": fam, "records": records, "launches": per,
               "engine_kernels": repr(eng.kernels), "key": choice["key"]}
        if model == "deit_small_patch16_224":
            # ivit: the fused kernels timed against "ops" (the standalone
            # kernels); ibert: no unfused path launches a kernel, no probe
            probed = Engine(spec, probe_images=x)
            rep = probed.fusion["path_choice"]
            same = np.array_equal(probed(x).cpu().numpy(), outs["blocks"])
            want = "timed-probe" if fam == "ivit" else "static-table"
            if rep["source"] != want or probed.kernels not in (True, "ops") or not same or \
                    (fam != "ivit" and probed.kernels is not True):
                raise AssertionError(f"dispatch {name}: probe {rep}, kernels "
                                     f"{probed.kernels!r}, logits equal: {same}")
            rec["probe"] = {**rep, "kernels": repr(probed.kernels)}
            del probed
        out["vit"].append(rec)
        del eng, spec, x, outs
        torch.cuda.empty_cache()

    args = path_compare.parse_args(["--model", "swin_tiny_patch4_window7_224", "--fam",
                                    "ivit", "--batch", str(SWIN_BATCH), "--device", "cuda"])
    _, spec, x = path_compare.setup(args)
    (records, outs), launches = run_counted(torch, counters, lambda: swin_path_compare.compare(
        spec, x, DISPATCH_SWIN_MODES, DISPATCH_SWIN_ITERS, emit=quiet))
    checks = path_compare.checks(outs, "fused")
    if not all(c["bitwise_equal_vs_fused"] for c in checks):
        raise AssertionError(f"dispatch Swin-T: modes differ {checks}")
    if not launches["swin_attn_block"] or not launches["mlp_block"]:
        raise AssertionError(f"dispatch Swin-T: launches {launches}")
    eng = Engine(spec)
    choice = eng.fusion["path_choice"]
    paths, _ = dispatch.swin_stage_choice(spec.config)
    got = eng(x).cpu().numpy()
    if choice["source"] != "swin-stage-table" or \
            eng.fusion["fused_attn_stages"] != list(paths) or \
            not np.array_equal(got, outs["fused"]):
        raise AssertionError(f"dispatch Swin-T: Engine(spec) took {choice}")
    ms = {r["mode"]: r["ms_per_batch"] for r in records if "ms_per_batch" in r}
    for i, dim in enumerate(96 * 2 ** i for i in range(4)):
        on, off = swin_path_compare.STAGE_PAIRS[i]
        fused = dispatch.MEASURED_SWIN_STAGE[dim]["fused"]
        slower(f"Swin-T stage {i} (C {dim})", on if fused else off, off if fused else on, ms)
    fused = dispatch.MEASURED["swin", 96]["fused"]
    slower("Swin-T", "fused" if fused else "unfused", "unfused" if fused else "fused", ms)
    out["swin"] = {"records": records, "launches": launches, "stage_paths": list(paths)}
    del eng, spec, x, outs
    torch.cuda.empty_cache()

    for k in ("attn_block", "mlp_block", "shiftmax", "shift_gelu_requant"):
        rows[k]["launches_dispatch_forward"] = {n: p[k] for n, p in launch_rows.items()}
    rows["swin_attn_block"]["launches_dispatch_swin"] = launches["swin_attn_block"]
    seconds = time.perf_counter() - t_phase
    emit({"phase": "dispatch", "seconds": seconds, "nvidia_smi": smi, **out})


def lap(step_s, name, since):
    step_s[name] = time.perf_counter() - since
    return time.perf_counter()


def profile_serving(torch, srv, images):
    """The card's idle share while ``srv`` serves ``images`` (torch.profiler,
    CUDA activity): 1 - device busy time / wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = serve_clients(srv, images, SERVE_CLIENTS, SERVE_WINDOW)
        torch.cuda.synchronize()
    busy_ms = sum(a.self_device_time_total for a in prof.key_averages()
                  if a.device_type == DeviceType.CUDA) / 1e3
    return max(0.0, 1.0 - busy_ms / (wall * 1e3))


def profile_call(torch, fn):
    """``fn()`` once under torch.profiler (CUDA activity): its result and
    the device's busy ms, the wall ms, the idle share and the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [a for a in prof.key_averages()
              if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
    busy = sum(a.self_device_time_total for a in device) / 1e3
    return out, {"wall_ms": wall_ms, "device_ms": busy,
                 "idle_share": max(0.0, 1.0 - busy / wall_ms),
                 "device_launches": sum(a.count for a in device)}


def profile_forward(torch, name, eng, images, n=3):
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
    device = [a for a in prof.key_averages()
              if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0]
    kernels = {a.key: a.self_device_time_total / 1e3 / n for a in device}
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": "profile", "engine": name, "forwards": n,
            "wall_ms_per_forward": wall_ms, "device_ms_per_forward": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_launches_per_forward": sum(a.count for a in device) / n,
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the engine forwards")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    try:
        from ivit_tpu_torch.ops.kernels import _build
        from ivit_tpu_torch.ops.kernels import block as kb
        from ivit_tpu_torch.ops.kernels import nonlinear as knl
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
    ptxas = {n: _build.ptxas_report(log) for n, log in _build.compiler_logs().items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": times, "ptxas": ptxas})
    spills = [k for n in _build.SOURCES for k in ptxas.get(n, []) if k["spill_bytes"]]
    if spills:
        raise AssertionError(f"kernels spill: {spills}")
    rows = kernel_phases(torch, kb, knl, dev)
    swin_phases(torch, kb, dev, rows)
    ppoly_phases(torch, kb, dev, rows)
    int16_kernel_phase(torch, kb, dev, rows)
    int16_edge_phase(torch, kb, dev)
    attn_edge_phase(torch, kb, dev)
    mlp_edge_phase(torch, kb, knl, dev)
    ln_requant_phase(torch, knl, dev, rows)
    emit({"phase": "kernel_checks_done", "seconds": time.perf_counter() - t0})
    counters = {"attn_block": kb.attn_block, "mlp_block": kb.mlp_block,
                "swin_attn_block": kb.swin_attn_block, "shiftmax": knl.shiftmax,
                "shift_gelu_requant": knl.shift_gelu_requant, "ln_requant": knl.ln_requant}
    # the table forms' and the integer-sqrt LN's own counts: 0 in every
    # phase but the lut phase, which takes them
    for k in ("attn_block", "mlp_block", "swin_attn_block"):
        counters[f"{k}[lut]"] = FormCount(counters[k], "lut_launches")
        counters[f"{k}[int_sqrt]"] = FormCount(counters[k], "int_sqrt_launches")
    engine_img_s = engine_phases(torch, counters, dev, rows, profile=args.profile)
    swin_engine_phase(torch, counters, dev, rows, profile=args.profile)
    ppoly_engine_phase(torch, counters, dev, rows, profile=args.profile)
    int16_engine_phase(torch, counters, dev, rows, profile=args.profile)
    emit({"phase": "engines_done", "seconds": time.perf_counter() - t0})
    vit_frozen = qat_freeze_phase(torch, counters, dev, rows, smi, profile=args.profile)
    emit({"phase": "qat_freeze_done", "seconds": time.perf_counter() - t0})
    swin_frozen = qat_freeze_swin_phase(torch, counters, dev, rows, smi,
                                        profile=args.profile)
    emit({"phase": "qat_freeze_swin_done", "seconds": time.perf_counter() - t0})
    lut_phase(torch, kb, counters, dev, rows, smi, vit_frozen, swin_frozen)
    emit({"phase": "lut_done", "seconds": time.perf_counter() - t0})
    serving_phase(torch, counters, dev, rows, smi, swin_frozen[0]["ivit"][0],
                  profile=args.profile)
    emit({"phase": "serving_done", "seconds": time.perf_counter() - t0})
    train_phase(torch, counters, dev, rows, smi, profile=args.profile)
    emit({"phase": "train_done", "seconds": time.perf_counter() - t0})
    trainer_phase(torch, counters, dev, rows, smi, profile=args.profile)
    emit({"phase": "trainer_done", "seconds": time.perf_counter() - t0})
    compat_cli_phase(torch, counters, dev, rows, smi, engine_img_s)
    emit({"phase": "compat_cli_done", "seconds": time.perf_counter() - t0})
    parallel_phase(torch, counters, dev, rows, smi)
    emit({"phase": "parallel_done", "seconds": time.perf_counter() - t0})
    scripts_phase(torch, counters, dev, rows, smi)
    emit({"phase": "scripts_done", "seconds": time.perf_counter() - t0})
    dispatch_phase(torch, counters, dev, rows, smi)
    emit({"phase": "dispatch_done", "seconds": time.perf_counter() - t0})
    emit({"kernels": list(rows.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
