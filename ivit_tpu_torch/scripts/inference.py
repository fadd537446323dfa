"""Inference / evaluation / engine-export CLI of the port (counterpart of
``scripts/inference.py``, flag for flag, plus ``--device``), on the card by
default.

Loads a checkpoint (the port's or JAX's directory format, or a reference
``.pth.tar``), rebuilds the sim from its ``model_config`` with the CLI's
overrides of approximation types and bitwidths, optionally recalibrates
and fits the ppoly tables, freezes to the integer engine and evaluates
top-1/3/5 with per-batch latency.  ``--export-engine`` saves the frozen
spec (``engine/export.py``), ``--io-stats`` the per-layer IO statistics.

  python -m ivit_tpu_torch.scripts.inference --weights ckpt.pth.tar \\
      --dataset synthetic --batch-size 256 --max-batches 4 \\
      --export-engine eng.npz --io-stats io.csv
  python -m ivit_tpu_torch.scripts.inference ... --device cpu

The engine takes the path ``Engine(spec)`` resolves (on the card, the
H100 A/B table of ``engine/dispatch.py``); ``--no-pallas`` runs the plain
engine (``kernels=False``), as it runs JAX's unfused one.  ``main(argv)``
returns the printed result.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np

_TORCH_SUFFIXES = (".pth.tar", ".pth", ".tar")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="I-ViT inference (PyTorch/CUDA port)")
    p.add_argument("--weights", required=True,
                   help="checkpoint dir (the port's or JAX's) or reference .pth.tar")
    p.add_argument("--model", default=None, help="override model name")
    p.add_argument("--gelu", default=None)
    p.add_argument("--softmax", default=None)
    p.add_argument("--layernorm", default=None)
    p.add_argument("--bitwidth", default=None)
    p.add_argument("--data-path", default=None)
    p.add_argument("--dataset", default="synthetic",
                   choices=["imagenet", "cifar100", "synthetic"])
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--calibration-batches", type=int, default=0,
                   help="re-calibrate ranges before freezing")
    p.add_argument("--engine", choices=["int", "sim"], default="int",
                   help="int = integer engine (kernels), sim = QAT fake-quant")
    p.add_argument("--no-pallas", action="store_true",
                   help="the plain engine (kernels=False)")
    p.add_argument("--export-engine", default=None,
                   help="save the frozen integer EngineSpec to this path")
    p.add_argument("--io-stats", default=None,
                   help="write per-layer IO statistics to this CSV")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="where the model runs: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def load_model_and_vars(args):
    """The sim (on ``args.device``) with the checkpoint's variables, and the
    model_config after the CLI's overrides."""
    from ivit_tpu_torch.models import BitWidths, str2model

    is_torch = args.weights.endswith(_TORCH_SUFFIXES)
    if is_torch:
        from ivit_tpu_torch.compat.torch_ckpt import (load_into_model,
                                                      load_torch_checkpoint)
        _, model_config = load_torch_checkpoint(args.weights)
        model_config = dict(model_config or {})
    else:
        from ivit_tpu_torch.train.checkpoint import load_meta
        model_config = load_meta(args.weights)["model_config"]

    # CLI overrides
    if args.model:
        model_config["model"] = args.model
    for key, val in (("gelu_type", args.gelu), ("softmax_type", args.softmax),
                     ("layernorm_type", args.layernorm)):
        if val:
            model_config[key] = val
    kwargs = dict(
        gelu_type=model_config.get("gelu_type", "ivit"),
        softmax_type=model_config.get("softmax_type", "ivit"),
        layernorm_type=model_config.get("layernorm_type", "ivit"),
        img_size=args.img_size, device=args.device)
    if args.num_classes:
        kwargs["num_classes"] = args.num_classes
    if args.bitwidth:
        kwargs["bitwidths"] = BitWidths.from_spec(args.bitwidth)
    model = str2model(model_config["model"])(**kwargs)

    if is_torch:
        load_into_model(model, args.weights, strict=False)
    else:
        from ivit_tpu_torch.models.convert import variables_to_torch
        from ivit_tpu_torch.train.checkpoint import load_variables
        variables_to_torch(model, load_variables(args.weights))
    return model, model_config


def build_datasets(args, num_classes):
    from ivit_tpu_torch.train.data import (CIFAR100Dataset, ImageFolderDataset,
                                           SyntheticDataset)
    if args.dataset == "synthetic":
        ncls = args.num_classes or num_classes
        return (SyntheticDataset(n=8 * args.batch_size, num_classes=ncls,
                                 img_size=args.img_size, seed=1),
                SyntheticDataset(n=8 * args.batch_size, num_classes=ncls,
                                 img_size=args.img_size, seed=2))
    if args.dataset == "cifar100":
        return (CIFAR100Dataset(args.data_path, train=False),
                CIFAR100Dataset(args.data_path, train=True))
    return (ImageFolderDataset(f"{args.data_path}/val"),
            ImageFolderDataset(f"{args.data_path}/train"))


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    import torch

    from ivit_tpu_torch import resolve_device
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.freeze import freeze_model
    from ivit_tpu_torch.train.data import data_loader

    dev = resolve_device(args.device)
    model, model_config = load_model_and_vars(args)
    logging.info("model config: %s", model_config)
    ds, ds_cal = build_datasets(args, model.num_classes)

    if args.calibration_batches:
        from ivit_tpu_torch.train.steps import make_calibration_step
        calib = make_calibration_step(model)
        for i, batch in enumerate(data_loader(
                ds_cal, args.batch_size, train=True, img_size=args.img_size)):
            if i >= args.calibration_batches:
                break
            calib(batch["image"])

    if "ppoly" in (model.gelu_type + model.softmax_type):
        from ivit_tpu_torch.train.ppoly_fit import fit_ppoly_tables
        fit_ppoly_tables(model)

    if args.engine == "int":
        spec = freeze_model(model)
        eng = Engine(spec, device=dev, kernels=False if args.no_pallas else None)
        fwd = eng
        if args.export_engine:
            from ivit_tpu_torch.engine.export import save_engine
            save_engine(spec, args.export_engine)
            logging.info("saved engine spec to %s", args.export_engine)
    else:
        def fwd(x):
            with torch.no_grad():
                return model(x.to(dev), running_stat=False)

    if args.io_stats:
        from ivit_tpu_torch.utils.iostats import attach_io_stats, clear_io_stats
        clear_io_stats()             # this run's rows only, as a fresh process has
        fwd_stats = attach_io_stats(model)

    top1 = top3 = top5 = n = 0
    times = []
    for bi, batch in enumerate(data_loader(ds, args.batch_size, train=False,
                                           img_size=args.img_size,
                                           drop_last=True)):
        if args.max_batches and bi >= args.max_batches:
            break
        x = torch.from_numpy(batch["image"])
        t0 = time.perf_counter()
        # the host-to-device copy, the forward and the read back: the
        # window ends once the logits are on the host
        logits = fwd(x).cpu().numpy()
        times.append(time.perf_counter() - t0)
        order = np.argsort(-logits, axis=-1)
        lab = batch["label"][:, None]
        top1 += int((order[:, :1] == lab).any(-1).sum())
        top3 += int((order[:, :3] == lab).any(-1).sum())
        top5 += int((order[:, :5] == lab).any(-1).sum())
        n += len(batch["label"])
        if args.io_stats and bi == 0:
            fwd_stats(x.to(dev))

    times = np.asarray(times[1:] or times)
    result = {
        "top1": top1 / max(1, n), "top3": top3 / max(1, n),
        "top5": top5 / max(1, n), "images": int(n),
        "ms_per_batch": float(times.mean() * 1e3),
        "ms_per_image": float(times.mean() * 1e3 / args.batch_size),
        "images_per_sec": float(args.batch_size / times.mean()),
    }
    if args.io_stats:
        from ivit_tpu_torch.utils.iostats import save_io_stats
        save_io_stats(args.io_stats)
        logging.info("io stats written to %s", args.io_stats)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
