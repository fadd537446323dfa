"""Piecewise-polynomial parameter sweep (counterpart of
``scripts/ppoly_sweep.py``), on the card by default.

Sweeps degree x segments x scale-bits x backend of the GELU and softmax-exp
fits (``ops/ppoly.py::fit_gelu_table`` / ``fit_softmax_exp_table``, fitted
on the host), evaluates each table on ``--device`` over the 8-bit grid and
reports its error against the float golden function (GELU through
``scipy.special.erf``, as JAX's).

The GELU table's integers sit on the ``2**scale_bits`` grid whatever the
backend, so the port reads every backend's output as ``y_int /
2**scale_bits``.  JAX's multiplies the ibert backend's by the table's
``out_scale`` (``scripts/ppoly_sweep.py:49-51``), I-BERT's composite output
scale, and reports an error of about 15,640 at scale 0.05 where the
integers are 0.103 off erf: a fault of the reference that the port does not
copy.

    python -m ivit_tpu_torch.scripts.ppoly_sweep --function gelu \\
        --degrees 1 2 3 --segments 8 16 32 --device cpu

``sweep(...)`` returns the rows it prints; ``main(argv)`` too.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _eval(table, x_int, dev):
    """The table's integers at ``x_int``, evaluated on ``dev``."""
    from ivit_tpu_torch.ops import ppoly

    y_int = ppoly.eval_piecewise_poly(torch.from_numpy(x_int).to(dev),
                                      table.bounds.astype(np.float32),
                                      table.coeffs.astype(np.float32))
    return y_int.cpu().numpy()


def sweep(function, scale, degrees, segments, scale_bits_list, backends,
          optim_bounds, device=None):
    from scipy.special import erf

    from ivit_tpu_torch import resolve_device
    from ivit_tpu_torch.ops import ppoly

    dev = resolve_device(device)
    rows = []
    x_int = np.arange(-128, 128, dtype=np.float32)
    for deg in degrees:
        for seg in segments:
            for nbits in scale_bits_list:
                for backend in backends:
                    if function == "gelu":
                        table = ppoly.fit_gelu_table(
                            x_int.min() * scale, x_int.max() * scale, scale,
                            scale_bits=nbits, seg=seg, deg=deg,
                            backend=backend, optim_bounds=optim_bounds)
                        xs = x_int * scale
                        y = _eval(table, x_int, dev) / 2.0**nbits
                        ref = xs * 0.5 * (1 + erf(xs / np.sqrt(2)))
                    else:
                        table = ppoly.fit_softmax_exp_table(
                            -128, 127, scale, scale_bits=nbits, seg=seg,
                            deg=deg, backend=backend,
                            optim_bounds=optim_bounds)
                        x_off = np.arange(-128, 128, dtype=np.float32)
                        y = np.clip(_eval(table, x_off, dev), 0, None) / 2.0**nbits
                        ref = np.exp((x_off - 127) * scale)
                    err = np.abs(y - ref)
                    rows.append({
                        "function": function, "deg": deg, "seg": seg,
                        "scale_bits": nbits, "backend": backend,
                        "max_err": float(err.max()),
                        "mean_err": float(err.mean()),
                    })
                    print(f"{function} deg={deg} seg={seg:3d} N={nbits} "
                          f"backend={backend:6s} max={err.max():.6f} "
                          f"mean={err.mean():.6f}")
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ppoly parameter sweep "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--function", default="gelu", choices=["gelu", "softmax"])
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--degrees", type=int, nargs="+", default=[1, 2])
    p.add_argument("--segments", type=int, nargs="+", default=[8, 16, 32])
    p.add_argument("--scale-bits", type=int, nargs="+", default=[22])
    p.add_argument("--backends", nargs="+", default=["float"])
    p.add_argument("--optim-bounds", action="store_true")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the tables are evaluated: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    rows = sweep(args.function, args.scale, args.degrees, args.segments,
                 args.scale_bits, args.backends, args.optim_bounds, args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
