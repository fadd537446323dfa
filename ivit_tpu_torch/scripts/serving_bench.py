"""Serving latency benchmark of the port (counterpart of
``scripts/serving_bench.py``; ``--cpu`` becomes ``--device``).

Runs the continuous-batching ``ServingEngine`` (DeiT-S INT8 by default) at
several batch sizes, recording p50/p95/max request latency and
throughput, next to the raw engine's throughput at batch 64 on input
already on the device (the batching overhead bound); then the overload
A/B: an open-loop burst against an unbounded queue and against
``max_queue`` + ``deadline_ms``.  The JSON records the card's name and
power limit (``nvidia-smi``) where JAX's records its backend.

    python -m ivit_tpu_torch.scripts.serving_bench --out SERVING_CUDA.json
    python -m ivit_tpu_torch.scripts.serving_bench --device cpu --requests 8

``path_choice`` is ``Engine(spec)``'s: on the card the report of the H100
A/B table (``engine/dispatch.py``), as JAX's records its TPU table's.
``main(argv)`` returns the result it writes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import deque


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Serving benchmark (PyTorch/CUDA port)")
    ap.add_argument("--out", default="SERVING_CUDA.json")
    ap.add_argument("--model", default="deit_small_patch16_224")
    ap.add_argument("--families", default="ibert")
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--batches", default="1,8,32,64")
    ap.add_argument("--device", default="cuda",
                    help="where the server runs: 'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def card_name(dev) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None):
    args = parse_args(argv)
    from concurrent.futures import CancelledError

    import numpy as np
    import torch

    from ivit_tpu_torch import resolve_device
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.engine.serving import (DeadlineExceeded, QueueFull,
                                               ServingEngine)
    from ivit_tpu_torch.models import str2model
    from ivit_tpu_torch.utils.benchmarking import time_dispatch

    dev = resolve_device(args.device)
    fam = args.families
    rng = np.random.default_rng(0)
    model = str2model(args.model)(gelu_type=fam, softmax_type=fam,
                                  layernorm_type=fam, device=dev, seed=0)
    img = model.img_size
    x_cal = torch.from_numpy(rng.normal(size=(16, img, img, 3)).astype(np.float32))
    with torch.no_grad():
        model(x_cal.to(dev), running_stat=True)
    spec = freeze_model(model)
    del model

    result = {"model": args.model, "families": fam, "card": card_name(dev),
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "requests_per_point": args.requests, "points": []}

    # raw engine throughput bound at batch 64 (input already on the device)
    eng = Engine(spec, device=dev)
    xb = torch.from_numpy(rng.normal(size=(64, img, img, 3)).astype(np.float32)).to(dev)
    t = time_dispatch(eng, xb, iters=20)
    result["raw_engine_b64_img_s"] = round(64 / t, 1)
    result["path_choice"] = eng.fusion.get("path_choice")
    del eng, xb

    imgs = rng.normal(size=(256, img, img, 3)).astype(np.float32)
    for bs in [int(b) for b in args.batches.split(",")]:
        with ServingEngine(spec, batch_size=bs, max_wait_ms=2.0, inflight=2,
                           device=dev) as srv:
            srv.infer(imgs[:bs])             # warm, outside the window
            srv.metrics = type(srv.metrics)()
            # closed loop, at most two batches outstanding: the latency is
            # the service time at a sustainable load, not a burst's queue
            t0 = time.perf_counter()
            outstanding: deque = deque()
            for i in range(args.requests):
                outstanding.append(srv.submit(imgs[i % len(imgs)]))
                while len(outstanding) >= 2 * bs:
                    outstanding.popleft().result()
            while outstanding:
                outstanding.popleft().result()
            wall = time.perf_counter() - t0
            snap = srv.metrics.summary()
        point = {"batch_size": bs, "wall_s": round(wall, 3),
                 "throughput_img_s": round(args.requests / wall, 1), **snap}
        result["points"].append(point)
        print(json.dumps(point), flush=True)

    # --- overload A/B: admission control + deadline vs unbounded queue ---
    # an open-loop burst above the service rate: with an unbounded queue the
    # p95 is the queue's depth; with max_queue + deadline_ms stale requests
    # are shed or rejected and the served ones' latency stays bounded
    bs, n_offer = 32, 256
    for tag, kw in (("unbounded", {}),
                    ("bounded", {"max_queue": 2 * bs, "deadline_ms": 2000.0})):
        with ServingEngine(spec, batch_size=bs, max_wait_ms=2.0, inflight=2,
                           device=dev, **kw) as srv:
            srv.infer(imgs[:bs])
            srv.metrics = type(srv.metrics)()
            futs, rejected = [], 0
            t0 = time.perf_counter()
            for i in range(n_offer):
                try:
                    futs.append(srv.submit(imgs[i % len(imgs)]))
                except QueueFull:
                    rejected += 1
            served = shed = 0
            for f in futs:
                try:
                    f.result()
                    served += 1
                except (DeadlineExceeded, CancelledError):
                    shed += 1
            wall = time.perf_counter() - t0
            snap = srv.metrics.summary()
        # the client's counts last: they are the ones that add up to offered
        point = {"mode": tag, "batch_size": bs, "offered": n_offer, **kw, **snap,
                 "served": served, "rejected": rejected, "shed": shed,
                 "wall_s": round(wall, 3)}
        result.setdefault("overload_ab", []).append(point)
        print(json.dumps(point), flush=True)

    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
