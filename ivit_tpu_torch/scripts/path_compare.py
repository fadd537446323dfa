"""Engine path A/B of the port (counterpart of ``scripts/path_compare.py``),
on the card by default.

Times the frozen ViT/DeiT integer engine whole-model on each path with
``utils.benchmarking.time_dispatch`` (one warm call, then ``--iters`` calls,
the device synchronized after them): ``blocks`` the fused block kernels
(``kernels=True``), ``ops`` the standalone nonlinearity kernels inside the
unfused engine (``kernels="ops"``), ``plain`` the plain per-op engine
(``kernels=False``, JAX's ``xla``).  The spec is the registry's seeded sim
with ``--fam``'s GELU, softmax and LayerNorm, calibrated on 8 seeded
images and frozen, as JAX's ``scripts/kernel_microbench.py::build_spec``
makes it.  Prints the card's name and power limit, then one JSON line a
mode (JAX's keys), then with ``--check`` whether each mode's logits equal
the first mode's bitwise.  ``--passes 2`` runs the modes twice, the second
time in the reverse order, each line with its ``pass``, as the rows of
``engine/dispatch.py::MEASURED`` were measured:

    python -m ivit_tpu_torch.scripts.path_compare --model deit_tiny_patch16_224 \\
        --batch 256 --iters 10 --modes blocks,ops,plain --passes 2 --check
    python -m ivit_tpu_torch.scripts.path_compare --model deit_small_patch16_224 \\
        --fam ibert --modes blocks,ops --check
    python -m ivit_tpu_torch.scripts.path_compare --device cpu --batch 2 --iters 1

``compare(spec, x, modes, iters)`` runs the modes (each ``iters + 2``
forwards: one for the logits, one warm, ``iters`` timed) and returns the
records and the logits; ``main(argv)`` returns every line it prints.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

MODES = {"blocks": True, "ops": "ops", "plain": False}


def parse_args(argv=None, model="deit_tiny_patch16_224", batch=256, iters=20,
               modes="blocks,ops,plain"):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=model)
    ap.add_argument("--fam", default="ivit",
                    help="one family for the GELU, softmax and LayerNorm")
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--iters", type=int, default=iters)
    ap.add_argument("--modes", default=modes)
    ap.add_argument("--check", action="store_true",
                    help="report whether every mode's logits equal the first's")
    ap.add_argument("--passes", type=int, default=1,
                    help="run the modes this many times, every other pass in "
                         "the reverse order; each line then names its pass")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: 'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def setup(args):
    """(device, spec with its parameters on the device, seeded images):
    the calibration images and the timed batch are one seeded draw, as
    JAX's scripts take them."""
    from ivit_tpu_torch import resolve_device
    from ivit_tpu_torch.engine.convert import params_to_torch
    from ivit_tpu_torch.scripts import scaling_bench

    dev = resolve_device(args.device)
    spec = scaling_bench.build_spec(args.model, args.fam, dev, seed=0)
    spec = type(spec)(spec.config, params_to_torch(spec.params, dev))
    img = spec.config.img_size
    x = torch.from_numpy(scaling_bench.images(8 + args.batch, img, 0)[8:]).to(dev)
    return dev, spec, x


def card_line(dev, **fields) -> dict:
    from ivit_tpu_torch.scripts.serving_bench import card_name
    return {"card": card_name(dev), **fields}


def time_mode(fwd, x, iters):
    """(seconds a batch, numpy logits) of one path."""
    from ivit_tpu_torch.utils.benchmarking import time_dispatch
    out = fwd(x).cpu().numpy()
    return time_dispatch(fwd, x, iters=iters), out


def record(mode, t, batch) -> dict:
    return {"mode": mode, "ms_per_batch": round(t * 1e3, 2),
            "images_per_sec": round(batch / t, 1)}


def checks(outs, base, want=None, **tag) -> list:
    """One line a mode: its logits equal ``want`` (default ``outs[base]``)."""
    want = outs[base] if want is None else want
    return [{"mode": mode, "bitwise_equal_vs_" + base: bool(np.array_equal(want, o)),
             **tag} for mode, o in outs.items()]


def compare(spec, x, modes, iters, emit=print, tag=None):
    """Each mode of ``modes`` through ``Engine`` on ``x``'s device: the
    records (JAX's keys, then ``tag``) and ``{mode: logits}``."""
    from ivit_tpu_torch.engine import Engine

    records, outs = [], {}
    for mode in modes:
        eng = Engine(spec, device=x.device, kernels=MODES[mode])
        t, outs[mode] = time_mode(eng, x, iters)
        records.append({**record(mode, t, x.shape[0]), **(tag or {})})
        emit(json.dumps(records[-1]))
    return records, outs


def run_passes(args, compare_fn):
    """``args.passes`` runs of ``compare_fn(modes, emit=, tag=)``, every
    other one in the reverse order, then with ``--check`` each pass's
    logits against the first mode's of the first pass: the lines printed
    after the card's."""
    modes = args.modes.split(",")
    lines, base, want = [], None, None
    for p in range(args.passes):
        tag = {"pass": p} if args.passes > 1 else {}
        records, outs = compare_fn(modes if p % 2 == 0 else modes[::-1], tag=tag,
                                   emit=lambda s: print(s, flush=True))
        lines += records
        if args.check and len(outs) > 1:
            if base is None:
                base = next(iter(outs))
                want = outs[base]
            for line in checks(outs, base, want, **tag):
                print(json.dumps(line), flush=True)
                lines.append(line)
    return lines


def main(argv=None):
    args = parse_args(argv)
    dev, spec, x = setup(args)
    lines = [card_line(dev, model=args.model, fam=args.fam, batch=args.batch)]
    print(json.dumps(lines[0]), flush=True)
    return lines + run_passes(args, lambda modes, **kw: compare(spec, x, modes,
                                                               args.iters, **kw))


if __name__ == "__main__":
    main()
