"""QAT training CLI of the port (counterpart of ``scripts/quant_train.py``,
the reference ``quant_train.py`` flag surface), on the card by default.

Examples:
  python -m ivit_tpu_torch.scripts.quant_train --model deit_small_patch16_224 \\
      --data-path /data/imagenet --epochs 90 --batch-size 128 --lr 5e-7 \\
      --gelu ivit --softmax ivit --layernorm ivit --bitwidth 8
  python -m ivit_tpu_torch.scripts.quant_train --dataset synthetic --epochs 1 \\
      --device cpu                                  # smoke run on the CPU
  python -m ivit_tpu_torch.scripts.quant_train --mesh-dp 2 --mesh-tp 2 ...
                                                    # 4 processes, cuda:0-3
  torchrun --nproc-per-node 8 -m ivit_tpu_torch.scripts.quant_train \\
      --distributed --mesh-tp 2 ...                 # one process a rank

``--data-path`` holds ``train/`` and ``val/`` in the ImageNet layout
(``root/<class>/<image>``); PNG and BMP files are decoded by the port
itself, JPEG and WebP need Pillow.  ``main(argv)`` takes the argument list
and returns the fitted :class:`~ivit_tpu_torch.train.trainer.Trainer`.
``--pretrained`` loads a reference ``.pth.tar`` or a timm-style float
``.pth`` into the sim before training (``compat/torch_ckpt.py``, not strict:
the leaves the file lacks keep their seeded values).

The mesh (JAX's ``--mesh-dp`` / ``--mesh-tp`` / ``--distributed``): the
Trainer runs one process a rank of a dp x tp world
(``train/trainer.py``).  ``--mesh-dp N --mesh-tp M`` spawns ``N * M``
local processes (``parallel.launch.spawn``) on ``cuda:0 .. N*M-1`` --
fewer cards than that raises, naming the count: a card is never shared
behind the caller's back -- or, with ``--device cpu``, on the CPU over
gloo; ``main`` then returns each rank's best top-1.  ``--distributed``
joins a torchrun-style ``env://`` world instead (``init_from_env``: the
rank on ``cuda:LOCAL_RANK``, or the CPU), ``--mesh-dp`` defaulting to
fill it.
"""

from __future__ import annotations

import argparse
import logging
import sys

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="I-ViT QAT training (PyTorch/CUDA port)")
    p.add_argument("--model", default="deit_tiny_patch16_224")
    p.add_argument("--data-path", default=None)
    p.add_argument("--dataset", default="imagenet",
                   choices=["imagenet", "cifar100", "synthetic"])
    p.add_argument("--synthetic-samples", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--eff-batch-size", type=int, default=None,
                   help="gradient-accumulation target batch size")
    p.add_argument("--lr", type=float, default=5e-7)
    p.add_argument("--warmup-epochs", type=int, default=0)
    p.add_argument("--warmup-lr", type=float, default=1e-7)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--model-ema", action="store_true")
    p.add_argument("--model-ema-decay", type=float, default=0.99996)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--repeated-aug", action="store_true")
    p.add_argument("--aa", default="rand-m9-mstd0.5-inc1",
                   help="RandAugment policy string (ref quant_train.py:117; "
                        "'none' disables)")
    # quantization config (ref quant_train.py:151-170)
    p.add_argument("--bitwidth", default="8",
                   help="'8' or 8-value CSV: patch_embed,pos_enc,block_in,"
                        "attn_out,softmax,mlp_out,norm2_in,att_block_out")
    p.add_argument("--gelu", default="ivit")
    p.add_argument("--softmax", default="ivit")
    p.add_argument("--layernorm", default="ivit")
    p.add_argument("--layer-type", default=None,
                   help="bulk override for gelu/softmax/layernorm")
    p.add_argument("--calibration-batches", type=int, default=10)
    p.add_argument("--calibration-epochs", type=int, default=0)
    # experiment infra
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="runs")
    p.add_argument("--run-id", default="")
    p.add_argument("--resume", default=None)
    p.add_argument("--pretrained", default=None,
                   help="reference .pth.tar or float weights to start from")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--log-grad-norm", action="store_true")
    p.add_argument("--mesh-dp", type=int, default=None,
                   help="data-parallel width over local devices")
    p.add_argument("--mesh-tp", type=int, default=1)
    p.add_argument("--distributed", action="store_true",
                   help="multi-process: join torchrun's env:// world")
    p.add_argument("--device", default="cuda",
                   help="where the sim trains: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_datasets(args):
    from ivit_tpu_torch.train.data import (CIFAR100Dataset, ImageFolderDataset,
                                           SyntheticDataset)

    if args.dataset == "synthetic":
        ncls = args.num_classes or 10
        n = args.synthetic_samples or 64 * args.batch_size
        return (SyntheticDataset(n=n, num_classes=ncls,
                                 img_size=args.img_size),
                SyntheticDataset(n=max(args.batch_size, n // 8),
                                 num_classes=ncls,
                                 img_size=args.img_size, seed=1),
                ncls)
    if args.dataset == "cifar100":
        tr = CIFAR100Dataset(args.data_path, train=True)
        va = CIFAR100Dataset(args.data_path, train=False)
        return tr, va, 100
    tr = ImageFolderDataset(f"{args.data_path}/train")
    va = ImageFolderDataset(f"{args.data_path}/val")
    return tr, va, tr.num_classes


def build_trainer(args):
    """The parsed arguments' datasets, config and Trainer (not yet fitted),
    the ``--pretrained`` weights loaded into its sim (unless resuming).  With
    ``--mesh-dp`` this process must already be a rank of its world."""
    from ivit_tpu_torch.train.trainer import TrainConfig, Trainer

    if args.layer_type:
        args.gelu = args.softmax = args.layernorm = args.layer_type

    ds_train, ds_val, ncls = build_datasets(args)
    cfg = TrainConfig(
        model=args.model, gelu_type=args.gelu, softmax_type=args.softmax,
        layernorm_type=args.layernorm, bitwidth=args.bitwidth,
        epochs=args.epochs, batch_size=args.batch_size,
        eff_batch_size=args.eff_batch_size, lr=args.lr,
        warmup_epochs=args.warmup_epochs, warmup_lr=args.warmup_lr,
        weight_decay=args.weight_decay, clip_grad=args.clip_grad,
        model_ema=args.model_ema, model_ema_decay=args.model_ema_decay,
        calibration_batches=args.calibration_batches,
        calibration_epochs=args.calibration_epochs,
        mixup=args.mixup, cutmix=args.cutmix, smoothing=args.smoothing,
        aa=args.aa,
        img_size=args.img_size, num_classes=args.num_classes or ncls,
        seed=args.seed, output_dir=args.output_dir, run_id=args.run_id,
        resume=args.resume, log_interval=args.log_interval,
        log_grad_norm=args.log_grad_norm,
        mesh_dp=args.mesh_dp, mesh_tp=args.mesh_tp)
    # on a mesh the Trainer takes the rank's own device
    trainer = Trainer(cfg, ds_train, ds_val,
                      device=None if args.mesh_dp else args.device)
    if args.pretrained and not args.resume:
        from ivit_tpu_torch.compat.torch_ckpt import load_into_model
        # in place: the train state holds the sim's own tensors
        _, report = load_into_model(trainer.model, args.pretrained, strict=False)
        logging.info("loaded pretrained weights (%d leaves, %d missing)",
                     len(report["matched"]), len(report["missing"]))
    return trainer


def _fit(args):
    trainer = build_trainer(args)
    best = trainer.fit()
    logging.info("best top-1: %.4f", best)
    return trainer


def _rank_main(rank, argv):
    """One spawned rank: the same arguments, this rank's world joined."""
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format=f"%(asctime)s rank{rank} %(levelname)s %(message)s")
    return _fit(parse_args(argv)).best_acc1


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if args.distributed:
        import torch.distributed as dist

        from ivit_tpu_torch.parallel.launch import init_from_env
        init_from_env(device=args.device)
        if args.mesh_dp is None:
            args.mesh_dp = dist.get_world_size() // args.mesh_tp
        try:
            return _fit(args)
        finally:
            dist.destroy_process_group()
    if args.mesh_dp:
        import torch

        from ivit_tpu_torch.parallel.launch import spawn
        world = args.mesh_dp * args.mesh_tp
        if args.device == "cpu":
            devices = ["cpu"] * world
        else:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if have < world:
                raise RuntimeError(
                    f"--mesh-dp {args.mesh_dp} --mesh-tp {args.mesh_tp} spawns "
                    f"{world} processes, one a card, and this host has {have} "
                    "card(s); pass --device cpu to run them on the CPU")
            devices = [f"cuda:{i}" for i in range(world)]
        return spawn(_rank_main, world, devices=devices, args=(argv,))
    return _fit(args)


if __name__ == "__main__":
    main(sys.argv[1:])
