"""Data-parallel scaling benchmark of the port (counterpart of
``scripts/scaling_bench.py``), on the card by default.

Measures the frozen integer engine's img/s at data-parallel widths over
``--devices`` and reports the efficiency against linear scaling.  Width
``w`` is a ``torch.distributed`` world of ``w`` ranks
(``parallel.launch.spawn``; width 1 a world of one, so every width runs the
same code), one device a rank: NCCL where the ranks hold distinct cards,
gloo where they share one or run on the CPU.  Each rank makes
``make_mesh(dp=w)``, takes its rows of one seeded batch and times
``engine_forward(..., mesh=)`` (the logits all-gathered over the ranks)
with ``utils.benchmarking.time_dispatch`` after a barrier; the width's
img/s is the batch over the slowest rank's time.  ``--serving`` adds a
``ServingEngine`` over the width's devices (one replica a device), in this
process.

A width above the number of cards is run only where ``--devices`` names a
card twice (``--devices cuda:0 cuda:0``): those ranks share the card over
gloo, so the total cannot grow with the width and their efficiency means
nothing; the artifact then carries ``throughput_gain_vs_1dev`` and says so
(likewise on the CPU).  The number means what it says only with a card a
rank.

    python -m ivit_tpu_torch.scripts.scaling_bench --serving --out SCALING_CUDA.json
    python -m ivit_tpu_torch.scripts.scaling_bench --devices cuda:0 cuda:0 --widths 1 2
    python -m ivit_tpu_torch.scripts.scaling_bench --device cpu --per-device-batch 2
    torchrun --nproc-per-node 8 -m ivit_tpu_torch.scripts.scaling_bench --distributed

``build_spec`` freezes the registry's seeded sim, ``measure`` times a spec
at each width, and ``main(argv)`` returns the artifact it prints (JAX's
keys, with ``card`` in place of ``backend``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

BLOCK_KERNELS = ("attn_block", "mlp_block", "swin_attn_block")
NONLINEAR_KERNELS = ("shiftmax", "shift_gelu_requant")
BATCH_SEED, SERVED_SEED = 1, 2     # offsets of the timed and served images' seeds
_SHARED_NOTE = (" Ranks share one device (several on one card over gloo, or "
                "CPU processes): total throughput cannot grow N-fold on the same "
                "silicon, so the efficiency means nothing; judge the curve by "
                "throughput_gain_vs_1dev. Scaling efficiency proper needs a card "
                "a rank.")


def images(n, img, seed):
    """``n`` seeded NHWC f32 images (a prefix of a longer draw of the seed)."""
    return np.random.default_rng(seed).normal(size=(n, img, img, 3)).astype(np.float32)


def build_spec(model="deit_small_patch16_224", family="ibert", device=None, seed=0):
    """The registry model with ``family``'s GELU, softmax and LayerNorm, a
    seeded init calibrated by one ``running_stat`` pass over 8 seeded
    images on ``device`` (default ``cuda``; raises without a card unless
    ``"cpu"``), frozen (``freeze_swin_model`` for a Swin)."""
    from ivit_tpu_torch import resolve_device
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.engine.swin_int import freeze_swin_model
    from ivit_tpu_torch.models import str2model

    dev = resolve_device(device)
    is_swin = model.startswith("swin")
    kw = dict(gelu_type=family, softmax_type=family, layernorm_type=family)
    if is_swin:
        kw["drop_path_rate"] = 0.0
    sim = str2model(model)(**kw, device=dev, seed=seed)
    x_cal = torch.from_numpy(images(8, sim.img_size, seed)).to(dev)
    with torch.no_grad():
        sim(x_cal, running_stat=True)
    return freeze_swin_model(sim) if is_swin else freeze_model(sim)


def _launch_counters():
    from ivit_tpu_torch.ops.kernels import block as kb
    from ivit_tpu_torch.ops.kernels import nonlinear as knl
    return {**{k: getattr(kb, k) for k in BLOCK_KERNELS},
            **{k: getattr(knl, k) for k in NONLINEAR_KERNELS}}


def _rank(rank, spec, batch, seed, kernels, iters):
    """One rank of a width: its rows of the seeded batch through the
    engine over the world's data axis.  Returns its seconds a forward, the
    launches and collectives of one forward, and the gathered logits."""
    import torch.distributed as dist

    from ivit_tpu_torch.engine.convert import params_to_torch
    from ivit_tpu_torch.engine.swin_int import SwinEngineSpec, swin_engine_forward
    from ivit_tpu_torch.engine.vit_int import engine_forward, transposed_mlp_weights
    from ivit_tpu_torch.parallel import collectives as coll
    from ivit_tpu_torch.parallel import local_rows, make_mesh
    from ivit_tpu_torch.parallel.launch import rank_device
    from ivit_tpu_torch.utils.benchmarking import time_dispatch

    dev = rank_device()
    mesh = make_mesh(dp=dist.get_world_size(), tp=1)
    x = torch.from_numpy(local_rows(images(batch, spec.config.img_size, seed),
                                    mesh)).to(dev)
    params = params_to_torch(spec.params, dev)
    local = type(spec)(spec.config, params)
    fwd = swin_engine_forward if isinstance(spec, SwinEngineSpec) else engine_forward
    mlp_wt = transposed_mlp_weights(params) if kernels is True else None

    def forward(a):
        return fwd(local, a, kernels=kernels, mlp_wt=mlp_wt, mesh=mesh)

    dist.barrier()
    seconds = time_dispatch(forward, x, iters=iters)
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    coll.reset_stats()
    with coll.timed():
        logits = forward(x)
    launches = {k: c.launches for k, c in counters.items()}
    return {"rank": rank, "device": str(dev), "seconds": seconds,
            "launches": launches,
            "collectives": {k: dict(v) for k, v in coll.STATS.items()},
            "logits": logits.cpu().numpy()}


def _serve(spec, devices, batch, kernels, seed):
    """JAX's serving pass: a warm batch of ``batch`` requests, then ``2 *
    batch`` timed ones.  Returns (img/s, the timed answers, their images)."""
    from ivit_tpu_torch.engine.serving import ServingEngine

    imgs = images(batch, spec.config.img_size, seed)
    with ServingEngine(spec, batch_size=batch, max_wait_ms=2, devices=devices,
                       kernels=kernels) as srv:
        for f in [srv.submit(im) for im in imgs]:
            f.result()
        n_reqs = 2 * batch
        t0 = time.perf_counter()
        futs = [srv.submit(imgs[i % batch]) for i in range(n_reqs)]
        served = np.stack([f.result() for f in futs])
        ips = n_reqs / (time.perf_counter() - t0)
    return ips, served, imgs


def shares_silicon(devices) -> bool:
    """Whether ranks on ``devices`` share one device or run on the CPU."""
    devs = [torch.device(d) for d in devices]
    return any(d.type == "cpu" for d in devs) or len(set(map(str, devs))) < len(devs)


def measure(spec, widths, *, devices, per_device_batch=32, iters=10, mode="weak",
            serving=False, kernels=True, seed=0, timeout=None):
    """Time ``spec`` at each width over ``devices[:width]`` (one a rank).

    Returns ``(results, runs)``: ``results`` JAX's per-width records;
    ``runs`` one dict a width with each rank's seconds, launches,
    collectives and gathered logits (``ranks``), the batch (``images``) and,
    with ``serving``, the server's answers (``served``) to ``served_images``
    (each image twice, in order)."""
    from ivit_tpu_torch.parallel.launch import spawn

    if max(widths) > len(devices):
        raise ValueError(f"width {max(widths)} needs {max(widths)} devices, one a "
                         f"rank; {len(devices)} given")
    shared = shares_silicon(devices[:max(widths)])
    img = spec.config.img_size
    results, runs = [], []
    base_ips = None
    for w in widths:
        devs = [str(d) for d in devices[:w]]
        bsz = per_device_batch * (w if mode == "weak" else max(widths))
        backend = "gloo" if shares_silicon(devs) else None
        ranks = spawn(_rank, w, backend=backend, devices=devs,
                      args=(spec, bsz, seed + BATCH_SEED, kernels, iters), timeout=timeout)
        ips = bsz / max(r["seconds"] for r in ranks)
        if base_ips is None:
            base_ips = ips
        # weak: perfect = w-fold throughput (efficiency <= 1.0); strong:
        # perfect = unchanged throughput on the same total batch
        eff = ips / (base_ips * w) if mode == "weak" else ips / base_ips
        rec = {"devices": w, "batch": bsz, "images_per_sec": round(ips, 1),
               "scaling_efficiency": round(eff, 3)}
        if mode == "weak" and shared:
            rec["throughput_gain_vs_1dev"] = round(ips / base_ips, 3)
        run = {"devices": devs, "backend": backend or "nccl", "ranks": ranks,
               "images": images(bsz, img, seed + BATCH_SEED)}
        if serving:
            srv_ips, run["served"], run["served_images"] = _serve(
                spec, devs, bsz, kernels, seed + SERVED_SEED)
            rec["serving_images_per_sec"] = round(srv_ips, 1)
            rec["serving_fraction_of_raw"] = round(srv_ips / ips, 3)
        results.append(rec)
        runs.append(run)
        print(f"dp={w:3d}: {ips:10.1f} img/s  efficiency {eff:.3f}", file=sys.stderr)
    return results, runs


def make_artifact(mode, card, model, family, results, shared):
    """JAX's ``SCALING.json`` layout, ``card`` in place of ``backend``."""
    if mode == "weak":
        note = ("weak scaling, fixed per-device batch: perfect = 1.0 (linear in "
                "devices)." + (_SHARED_NOTE if shared else ""))
    else:
        note = ("strong scaling (legacy): fixed total batch, perfect = 1.0 = no "
                "partitioning overhead")
    return {"mode": mode, "card": card, "model": model, "family": family,
            "note": note, "results": results}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Data-parallel scaling benchmark "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--model", default="deit_small_patch16_224")
    p.add_argument("--family", default="ibert")
    p.add_argument("--per-device-batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--widths", type=int, nargs="+", default=None)
    p.add_argument("--distributed", action="store_true",
                   help="measure the width of the torchrun world this process "
                        "joins (env://, the rank on cuda:LOCAL_RANK)")
    p.add_argument("--no-kernels", action="store_true",
                   help="the plain engine in place of the fused block kernels")
    p.add_argument("--mode", choices=["weak", "strong"], default="weak",
                   help="weak (default): fixed per-device batch, efficiency = "
                        "ips / (ips_1 * N) <= 1.0; strong: fixed total batch")
    p.add_argument("--serving", action="store_true",
                   help="also measure through ServingEngine at each width")
    p.add_argument("--out", default=None, help="write the JSON artifact here")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: every visible card, one a rank) or "
                        "'cpu' (two CPU ranks unless --widths asks for more)")
    p.add_argument("--devices", nargs="+", default=None,
                   help="one device a rank, e.g. cuda:0 cuda:0 (two ranks "
                        "sharing one card)")
    return p.parse_args(argv)


def _devices(args):
    """The ranks' devices: ``--devices``, else every visible card, else (the
    CPU) one a rank of the widest width."""
    from ivit_tpu_torch import resolve_device

    if args.devices:
        return args.devices
    if resolve_device(args.device).type == "cpu":
        return ["cpu"] * max(args.widths or [2])
    have = torch.cuda.device_count()
    if args.widths and max(args.widths) > have:
        raise RuntimeError(f"width {max(args.widths)} runs one rank a card, and this "
                           f"host has {have} card(s); name the devices with "
                           "--devices (cuda:0 cuda:0 shares one) or pass --device cpu")
    return [f"cuda:{i}" for i in range(have)]


def _card(device):
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _distributed(args, kernels):
    """This process's rank of a torchrun world: the world's width alone
    (one record, without an efficiency: there is no width-1 run to hold it
    to)."""
    import torch.distributed as dist

    from ivit_tpu_torch.parallel.launch import init_from_env

    if args.serving:
        raise ValueError("--serving runs its server in one process; it does not "
                         "combine with --distributed")
    dev = init_from_env(device=args.device)
    try:
        w = dist.get_world_size()
        bsz = args.per_device_batch * w
        spec = build_spec(args.model, args.family, dev)
        out = _rank(dist.get_rank(), spec, bsz, BATCH_SEED, kernels, args.iters)
        seconds = [None] * w
        dist.all_gather_object(seconds, out["seconds"])
    finally:
        dist.destroy_process_group()
    ips = bsz / max(seconds)
    rec = {"devices": w, "batch": bsz, "images_per_sec": round(ips, 1)}
    return make_artifact(args.mode, _card(dev), args.model, args.family, [rec],
                         shares_silicon([dev]))


def main(argv=None):
    args = parse_args(argv)
    kernels = not args.no_kernels
    if args.distributed:
        artifact = _distributed(args, kernels)
    else:
        devices = _devices(args)
        widths = args.widths or [w for w in (1, 2, 4, 8, 16, 32) if w <= len(devices)]
        spec = build_spec(args.model, args.family, devices[0])
        results, _ = measure(spec, widths, devices=devices,
                             per_device_batch=args.per_device_batch,
                             iters=args.iters, mode=args.mode, serving=args.serving,
                             kernels=kernels)
        artifact = make_artifact(args.mode, _card(devices[0]), args.model,
                                 args.family, results,
                                 shares_silicon(devices[:max(widths)]))
    print(json.dumps(artifact, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
    return artifact


if __name__ == "__main__":
    main(sys.argv[1:])
