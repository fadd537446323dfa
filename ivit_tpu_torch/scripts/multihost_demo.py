"""Multi-process execution of the port (counterpart of
``scripts/multihost_demo.py``).

Spawns ``--num-processes`` OS processes (``parallel.launch.spawn``), each a
rank of one ``torch.distributed`` world on gloo with one device (``--device
cpu``, or ``cuda``: ``cuda:rank``; a host with fewer cards than processes
raises, naming the count), and runs JAX's three flows across the process
boundary:

1. ``engine_dp`` -- the frozen integer engine over a data-parallel mesh of
   every rank: each rank runs its rows of the batch (the fused block
   kernels), the logits are all-gathered, and every rank checks them
   bitwise against its own single-device run of the whole batch;
2. ``sim_tp`` -- the QAT sim with its heads and hidden columns cut over a
   model axis that spans the processes (the row-sharded ``proj`` / ``fc2``
   sums and the ranges are cross-process collectives), bitwise against
   the single-device sim; and ``engine_tp``, the frozen engine on the same
   axis (``kernels="ops"``: the standalone Shiftmax and ShiftGELU kernels
   on the rank's heads and hidden columns), bitwise;
3. ``serving`` -- each process runs its own ``ServingEngine`` over
   ``--local-devices`` replicas of its device and checks the logits
   (``serving_logits_ok``: bitwise against the engine).

Run: ``python -m ivit_tpu_torch.scripts.multihost_demo --small --device cpu
--out MULTIHOST.json``.  The JSON has JAX's keys; ``global_devices`` counts
the ranks (one device each), ``local_devices`` a rank's devices (1).  The
default configuration is DeiT-S at 224 px (JAX's is DeiT-T, whose 3 heads
no 2-way head-aligned cut divides); ``--small`` a 64 px, depth-2 model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def build_engine(small, device, seed=0):
    """The demo's sim, calibrated on two seeded batches, and its frozen
    spec; returns ``(model, spec, img, rng)``."""
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.models import VisionTransformer, deit_small_patch16_224

    rng = np.random.default_rng(seed)
    if small:
        model = VisionTransformer(
            img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
            num_classes=10, gelu_type="ivit", softmax_type="ivit",
            layernorm_type="ivit", device=device, seed=seed)
        img = 64
    else:
        model = deit_small_patch16_224(device=device, seed=seed)
        img = 224
    with torch.no_grad():
        for _ in range(2):
            model(torch.from_numpy(rng.normal(size=(4, img, img, 3)).astype(np.float32)),
                  running_stat=True)
    return model, freeze_model(model), img, rng


def _worker(rank, args):
    import torch.distributed as dist

    from ivit_tpu_torch.engine.serving import ServingEngine
    from ivit_tpu_torch.engine.vit_int import engine_forward
    from ivit_tpu_torch.parallel import (local_rows, make_mesh, shard_engine_params,
                                         shard_module)
    from ivit_tpu_torch.parallel.launch import rank_device

    dev = rank_device()
    world = dist.get_world_size()
    rec = {"process_id": rank, "num_processes": world,
           "global_devices": world, "local_devices": 1, "device": str(dev)}
    model, spec, img, rng = build_engine(args["small"], dev)
    spec_cls = type(spec)

    # ---- 1. engine over a data-parallel mesh of every rank ---------------
    batch_global = 2 * world
    x_all = rng.normal(size=(batch_global, img, img, 3)).astype(np.float32)
    golden = engine_forward(spec, x_all, kernels=True, device=dev).cpu().numpy()
    mesh = make_mesh(dp=world, tp=1)
    t0 = time.perf_counter()
    got = engine_forward(spec, local_rows(x_all, mesh), kernels=True, mesh=mesh)
    got = got.cpu().numpy()
    rec["engine_dp_wall_s"] = time.perf_counter() - t0
    np.testing.assert_array_equal(got, golden)
    rec["engine_dp_bitexact"] = True
    dist.barrier()

    # ---- 2. sim forward, tensor-parallel across the processes -------------
    tp_mesh = make_mesh(dp=1, tp=world)
    x_sim = torch.from_numpy(x_all[:8])
    with torch.no_grad():
        want = model(x_sim).cpu().numpy()
        got_tp = shard_module(model, tp_mesh)(x_sim).cpu().numpy()
    np.testing.assert_array_equal(got_tp, want)
    rec["sim_tp_bitexact"] = True
    dist.barrier()

    # ---- 2b. the engine, tensor-parallel on the same axis -----------------
    local, _ = shard_engine_params(spec.params, tp_mesh)
    got_etp = engine_forward(spec_cls(spec.config, local), x_all[:8], kernels="ops",
                             mesh=tp_mesh).cpu().numpy()
    np.testing.assert_array_equal(got_etp, golden[:8])
    rec["engine_tp_bitexact"] = True
    dist.barrier()

    # ---- 3. per-process continuous-batched serving ------------------------
    n_local = args["local_devices"]
    images = rng.normal(size=(8 * n_local, img, img, 3)).astype(np.float32)
    want_srv = engine_forward(spec, images, kernels=True, device=dev).cpu().numpy()
    with ServingEngine(spec, batch_size=4 * n_local, max_wait_ms=20,
                       devices=[dev] * n_local) as srv:
        got_srv = srv.infer(images)
        summary = srv.metrics.summary()
    np.testing.assert_array_equal(got_srv, want_srv)
    rec["serving"] = summary
    rec["serving_logits_ok"] = True
    dist.barrier()

    os.makedirs(args["run_dir"], exist_ok=True)
    with open(os.path.join(args["run_dir"], f"worker_{rank}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _devices(device, n):
    if device == "cpu":
        return ["cpu"] * n
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no CUDA device is available; pass "
                           "--device cpu")
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"--num-processes {n} runs one process a card, and this "
                           f"host has {have} card(s); pass --device cpu to run "
                           "them on the CPU")
    return [f"cuda:{r}" for r in range(n)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--local-devices", type=int, default=2,
                   help="server replicas a process runs on its device")
    p.add_argument("--small", action="store_true",
                   help="64px depth-2 config (tests); default DeiT-S 224")
    p.add_argument("--timeout", type=float, default=3600)
    p.add_argument("--run-dir", default="runs/multihost")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from ivit_tpu_torch.parallel.launch import spawn

    n = args.num_processes
    workers = spawn(_worker, n, backend="gloo", devices=_devices(args.device, n),
                    args=({"small": args.small, "local_devices": args.local_devices,
                           "run_dir": args.run_dir},),
                    timeout=args.timeout)
    merged = {"num_processes": n,
              "local_devices_per_process": 1,
              "config": "small" if args.small else "deit_small_224",
              "workers": workers}
    merged["all_bitexact"] = all(
        w["engine_dp_bitexact"] and w["sim_tp_bitexact"] and w["engine_tp_bitexact"]
        for w in workers)
    merged["serving_images_per_sec_total"] = sum(
        w["serving"]["images_per_sec"] for w in workers)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=1)
        print(f"wrote {args.out}")
    print(json.dumps(merged, indent=1))
    return merged


if __name__ == "__main__":
    main(sys.argv[1:])
