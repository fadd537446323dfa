"""The control of the benchmark's correctness check, and the readings its
limit is set from.

The configuration states int8 weights and activations.  The control puts
the plain reference in the program's place, computed one precision lower:
every int8 weight rounded to the int4 grid (``clip(round(w / 16), -8, 7) *
16``, the same scales).  It is read with the check's own number, the
largest logit gap in head-accumulator LSBs against the int8 reference, over
as many batches as a run checks, drawn from the seed as a run draws them, at
the cell's own sizes:

    python3 -m gpubench.control --workload <name> --seeds 1 2 3

prints one JSON line a seed.  A sound run of the program reads 0 (the
integer engine is exact); the control must read above it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import cells, specmaker

WEIGHT_KEYS = ("w", "qkv_w", "proj_w", "fc1_w", "fc2_w", "head_w", "red_w")


def int4_weights(tree):
    """The spec tree with every int8 weight on the int4 grid."""
    if isinstance(tree, dict):
        return {k: (np.clip(np.round(v.astype(np.float32) / 16), -8, 7) * 16).astype(np.int8)
                if k in WEIGHT_KEYS else int4_weights(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [int4_weights(v) for v in tree]
    return tree


def readings(name, seeds, device="cuda", overrides=None, log=sys.stderr):
    """One ``{"seed", "control_gap_lsb", ...}`` a seed: the int4-weight
    reference against the int8 reference on batches drawn as a run draws
    them."""
    import torch

    from .harness import Feed, _gap, _make_images
    from .reference.common import tensors

    _, cfg, traffic = cells.cell(name)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {}), "images_on": "device"}
    ref = cells.reference(cfg)
    dev = torch.device(device)
    rows, B = traffic["check_rows_per_block"], traffic["batch"]
    out = []
    for seed in seeds:
        spec_cfg, params = specmaker.make(cfg, seed)
        feed = Feed(torch, _make_images(torch, traffic, cfg, seed, dev), traffic, seed, dev)
        p8, p4 = tensors(params, dev), tensors(int4_weights(params), dev)
        worst, bad = 0.0, 0
        with torch.no_grad():
            for _ in range(traffic["check_batches"]):
                _, x = feed.next()
                want = torch.cat([ref.forward(spec_cfg, p8, x[i:i + rows]).cpu()
                                  for i in range(0, B, rows)])
                got = torch.cat([ref.forward(spec_cfg, p4, x[i:i + rows]).cpu()
                                 for i in range(0, B, rows)])
                g, b = _gap(torch, got, want, p8["head_scale"].cpu())
                worst, bad = max(worst, g), bad + b
        line = {"workload": name, "seed": seed, "control_gap_lsb": worst,
                "images_differ": bad, "images": traffic["check_batches"] * B}
        print(json.dumps(line), file=log, flush=True)
        out.append(line)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="the int4 control's readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    readings(args.workload, args.seeds, log=sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
