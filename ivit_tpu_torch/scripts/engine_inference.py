"""Run a saved integer-engine artifact (counterpart of
``scripts/engine_inference.py``, flag for flag, plus ``--device``): the
*exported* deployment artifact evaluated, not the checkpoint, through
``Engine`` or, with ``--serve``, the continuous-batching ``ServingEngine``.

  python -m ivit_tpu_torch.scripts.engine_inference --engine eng.npz --dataset synthetic
  python -m ivit_tpu_torch.scripts.engine_inference --engine eng.npz --serve --batch-size 64

``Engine`` takes the path ``Engine(spec)`` resolves (on the card, the
H100 A/B table of ``engine/dispatch.py``), the server the fused kernels;
``--no-pallas`` runs the plain engine in both.  ``main(argv)`` returns the
printed result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run a saved integer engine (PyTorch/CUDA port)")
    p.add_argument("--engine", required=True, help="saved EngineSpec (.npz)")
    p.add_argument("--dataset", default="synthetic",
                   choices=["imagenet", "cifar100", "synthetic"])
    p.add_argument("--data-path", default=None)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--no-pallas", action="store_true",
                   help="the plain engine (kernels=False)")
    p.add_argument("--serve", action="store_true",
                   help="drive through the continuous-batching server")
    p.add_argument("--device", default="cuda",
                   help="where the engine runs: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ivit_tpu_torch import resolve_device
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.export import load_engine
    from ivit_tpu_torch.train.data import (CIFAR100Dataset, ImageFolderDataset,
                                           SyntheticDataset, data_loader)

    dev = resolve_device(args.device)
    spec = load_engine(args.engine, device=dev)
    cfg = spec.config
    print(f"engine: {cfg.gelu_type}/{cfg.softmax_type}/{cfg.layernorm_type} "
          f"dim={cfg.embed_dim} depth={cfg.depth} classes={cfg.num_classes}",
          file=sys.stderr)

    if args.dataset == "synthetic":
        ds = SyntheticDataset(n=8 * args.batch_size,
                              num_classes=cfg.num_classes,
                              img_size=cfg.img_size, seed=1)
    elif args.dataset == "cifar100":
        ds = CIFAR100Dataset(args.data_path, train=False)
    else:
        ds = ImageFolderDataset(f"{args.data_path}/val")

    kernels = False if args.no_pallas else None
    top1 = top5 = n = 0
    times = []

    def batches():
        for bi, batch in enumerate(data_loader(ds, args.batch_size, train=False,
                                               img_size=cfg.img_size,
                                               drop_last=True)):
            if args.max_batches and bi >= args.max_batches:
                return
            yield batch

    def count(logits, labels):
        nonlocal top1, top5, n
        order = np.argsort(-logits, axis=-1)
        lab = labels[:, None]
        top1 += int((order[:, :1] == lab).any(-1).sum())
        top5 += int((order[:, :5] == lab).any(-1).sum())
        n += len(labels)

    if args.serve:
        from ivit_tpu_torch.engine.serving import ServingEngine
        with ServingEngine(spec, batch_size=args.batch_size, device=dev,
                           kernels=kernels) as srv:
            for batch in batches():
                count(srv.infer(batch["image"]), batch["label"])
            metrics = srv.metrics.summary()
    else:
        eng = Engine(spec, device=dev, kernels=kernels)
        for batch in batches():
            x = torch.from_numpy(batch["image"])
            t0 = time.perf_counter()
            logits = eng(x).cpu().numpy()
            times.append(time.perf_counter() - t0)
            count(logits, batch["label"])
        t = np.asarray(times[1:] or times)
        metrics = {"ms_per_batch": float(t.mean() * 1e3),
                   "images_per_sec": float(args.batch_size / t.mean())}

    result = {"top1": top1 / max(1, n), "top5": top5 / max(1, n),
              "images": int(n), **metrics}
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
