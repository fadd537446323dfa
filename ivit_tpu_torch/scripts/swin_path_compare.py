"""Swin engine path A/B of the port (counterpart of
``scripts/swin_path_compare.py``), on the card by default.

Times the frozen Swin integer engine whole-model
(``utils.benchmarking.time_dispatch``, as ``path_compare`` does) across its
fusion variants, beside the bf16 float Swin (``models/vit_float.py``):

* ``fused`` both half-blocks on their kernels, ``attn`` / ``mlp`` only one
  (``swin_engine_forward(fuse_parts=)``), ``fused_nopad`` / ``mlp_nopad``
  the MLP kernel only on stages whose width is a multiple of 128, and
  ``unfused`` the plain engine;
* ``stages123``, ``stages23``, ``stages3``: the fused kernels from stage
  1, 2 or 3 on, the plain engine before (``stage_paths``);
* ``dispatch``: the stages ``engine/dispatch.py::swin_stage_choice``
  picks, printed first;
* ``bf16``: the float model.

The spec is the registry's seeded sim, calibrated on 8 seeded images and
frozen (``path_compare.setup``).  Prints the card's name and power limit,
one JSON line a mode (JAX's keys), and with ``--check`` whether each
integer mode's logits equal the first's bitwise (``--passes``: as
``path_compare``'s).  Its rows fill
``engine/dispatch.py::MEASURED_SWIN_STAGE``: each stage's row is the pair
of mixes that differ at that stage alone (``STAGE_PAIRS``).

    python -m ivit_tpu_torch.scripts.swin_path_compare --iters 15 --passes 2 \\
        --check --modes fused,stages123,stages23,stages3,unfused,attn,mlp,\\
fused_nopad,mlp_nopad,dispatch,bf16
    python -m ivit_tpu_torch.scripts.swin_path_compare --device cpu --batch 2

``compare(spec, x, modes, iters, model=)`` runs the modes and returns the
records and the integer modes' logits; ``main(argv)`` returns every line
it prints.
"""

from __future__ import annotations

import functools
import json

import torch

from ivit_tpu_torch.scripts import path_compare

FUSED = ("attn", "mlp")
# mode -> (kernels, fuse_parts, first fused stage or None for every stage)
VARIANTS = {
    "fused": (True, FUSED, None),
    "fused_nopad": (True, FUSED + ("mlp_nopad",), None),
    "attn": (True, ("attn",), None),
    "mlp": (True, ("mlp",), None),
    "mlp_nopad": (True, ("mlp", "mlp_nopad"), None),
    "unfused": (False, (), None),
    "stages23": (True, FUSED, 2),
    "stages123": (True, FUSED, 1),
    "stages3": (True, FUSED, 3),
}

# stage -> (the mix fused there, the mix unfused there): the two differ at
# that stage alone, fused after it and unfused before it
STAGE_PAIRS = {0: ("fused", "stages123"), 1: ("stages123", "stages23"),
               2: ("stages23", "stages3"), 3: ("stages3", "unfused")}


def stage_paths(cfg, mode):
    """The ``stage_paths`` of a mode (``None``: every stage as ``kernels``)."""
    first = VARIANTS[mode][2]
    return None if first is None else tuple(i >= first for i in range(len(cfg.depths)))


def compare(spec, x, modes, iters, model="swin_tiny_patch4_window7_224", emit=print,
            tag=None):
    """Each mode of ``modes`` on ``x``'s device: the records (JAX's keys,
    then ``tag``) and ``{mode: logits}`` of the integer modes."""
    from ivit_tpu_torch.engine import dispatch
    from ivit_tpu_torch.engine.swin_int import swin_engine_forward
    from ivit_tpu_torch.engine.vit_int import transposed_mlp_weights

    cfg = spec.config
    mlp_wt = transposed_mlp_weights(spec.params)
    records, outs = [], {}
    for mode in modes:
        if mode == "bf16":
            from ivit_tpu_torch.models.vit_float import float_swin_model
            fm = float_swin_model(model, img_size=cfg.img_size, device=x.device)
            with torch.no_grad():
                t, _ = path_compare.time_mode(fm, x, iters)
        else:
            if mode == "dispatch":
                paths, rep = dispatch.swin_stage_choice(cfg)
                line = {"mode": mode, "stage_paths": list(paths), "evidence": rep,
                        **(tag or {})}
                records.append(line)
                emit(json.dumps(line))
                kernels, parts = True, FUSED
            else:
                kernels, parts, _ = VARIANTS[mode]
                paths = stage_paths(cfg, mode)
            fwd = functools.partial(swin_engine_forward, spec, kernels=kernels,
                                    device=x.device, stage_paths=paths,
                                    mlp_wt=mlp_wt if kernels else None,
                                    fuse_parts=parts)
            t, outs[mode] = path_compare.time_mode(fwd, x, iters)
        records.append({**path_compare.record(mode, t, x.shape[0]), **(tag or {})})
        emit(json.dumps(records[-1]))
    return records, outs


def main(argv=None):
    args = path_compare.parse_args(argv, model="swin_tiny_patch4_window7_224",
                                   batch=64, iters=15,
                                   modes="fused,attn,mlp,unfused,bf16")
    dev, spec, x = path_compare.setup(args)
    lines = [path_compare.card_line(dev, model=args.model, fam=args.fam,
                                    batch=args.batch)]
    print(json.dumps(lines[0]), flush=True)
    return lines + path_compare.run_passes(
        args, lambda modes, **kw: compare(spec, x, modes, args.iters,
                                          model=args.model, **kw))


if __name__ == "__main__":
    main()
