"""Summarize an IO-statistics dump, or audit the integer engine's envelopes
(counterpart of ``scripts/analyze_io_stats.py``).

Reads the CSV written by ``ivit_tpu_torch.utils.iostats`` / the inference
CLI (with ``csv`` and numpy: no pandas) and reports the global integer
extrema, the share of layers that fit int8/16/32, per-module-type scale
and extrema statistics and the shape histogram.  ``--engine MODEL`` runs
the port's unfused engine under ``vit_int.audit_capture`` instead and
prints its per-site table, exiting 1 on a hard-bound violation.

  python -m ivit_tpu_torch.scripts.analyze_io_stats io_stats.csv
  python -m ivit_tpu_torch.scripts.analyze_io_stats --engine deit_small_patch16_224 \\
      --families ibert,ibert,ibert --device cpu
"""

from __future__ import annotations

import argparse
import csv
import math
import re
import sys
from collections import Counter

import numpy as np


def engine_audit(model_name: str, families: str, batch: int = 4, device="cuda"):
    """Build MODEL's sim (``seed=0``) with the ``gelu,softmax,ln`` families,
    calibrate it on ``batch`` seeded images, freeze it and run the plain
    engine (``kernels=False``) on them under the envelope-audit taps; print
    the per-site table.  Returns ``(records, violations)``: every record's
    numbers read to floats, and the hard sites (no ``sat_frac``) that
    escape their bounds."""
    import torch

    from ivit_tpu_torch import resolve_device
    from ivit_tpu_torch.engine.vit_int import (audit_capture, audit_violations,
                                               engine_forward)
    from ivit_tpu_torch.models import str2model

    dev = resolve_device(device)
    fams = families.split(",")
    is_swin = model_name.startswith("swin")
    kw = dict(gelu_type=fams[0], softmax_type=fams[1], layernorm_type=fams[2])
    if is_swin:
        kw["drop_path_rate"] = 0.0
    model = str2model(model_name)(device=dev, seed=0, **kw)
    rng = np.random.default_rng(0)
    img = model.img_size
    x = torch.from_numpy(rng.normal(size=(batch, img, img, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        model(x, running_stat=True)
    if is_swin:
        from ivit_tpu_torch.engine.swin_int import (freeze_swin_model,
                                                    swin_engine_forward)
        spec, fwd = freeze_swin_model(model), swin_engine_forward
    else:
        from ivit_tpu_torch.engine.freeze import freeze_model
        spec, fwd = freeze_model(model), engine_forward
    del model
    with audit_capture() as recs:
        fwd(spec, x, kernels=False, device=dev)
    # one device read for every site's numbers
    nums = torch.stack([torch.stack([r["min"], r["max"],
                                     r.get("sat_frac", torch.tensor(-1.0, device=dev))])
                        for r in recs]).cpu().tolist() if recs else []
    records = []
    print(f"{'site':16s} {'min':>14s} {'max':>14s} "
          f"{'lo_bound':>12s} {'hi_bound':>12s} {'sat%':>7s}")
    for r, (mn, mx, sat) in zip(recs, nums):
        rec = {k: r[k] for k in ("site", "kind", "lo_bound", "hi_bound")}
        rec.update(min=mn, max=mx)
        if "sat_frac" in r:
            rec["sat_frac"] = sat
        records.append(rec)
        sat_s = f"{sat * 100:7.3f}" if "sat_frac" in r else "      -"
        print(f"{rec['site']:16s} {mn:14.1f} {mx:14.1f} "
              f"{rec['lo_bound']:12.3g} {rec['hi_bound']:12.3g} {sat_s}")
    bad = audit_violations([r for r in records if "sat_frac" not in r])
    print(f"\nhard-bound violations: {len(bad)}")
    for r in bad:
        print("  VIOLATION", r)
    return records, bad


def read_io_stats(path: str):
    """The rows of an IO-stats CSV: numbers as floats (an empty cell NaN),
    ``layer`` / ``type`` / ``shape_out`` as text."""
    if path.endswith(".pkl"):
        raise ValueError(f"{path}: the port reads IO stats as CSV only (a .pkl "
                         "is a pickled pandas DataFrame; the port has no pandas)")
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    text = ("layer", "type", "shape_out")
    return [{k: (v if k in text else (float(v) if v != "" else math.nan))
             for k, v in r.items()} for r in rows]


def summarize(rows, per_layer: bool = False) -> dict:
    """The report's numbers: global integer extrema, the share of layers that
    fit each integer width, per module type (the layer's last path part,
    a trailing ``_<n>`` dropped) count, scale and integer extrema, and the
    ten commonest output shapes."""
    out = {"records": len(rows)}
    if rows and "min_out_int" in rows[0]:
        lo = np.array([r["min_out_int"] for r in rows], np.float64)
        hi = np.array([r["max_out_int"] for r in rows], np.float64)
        keep = ~(np.isnan(lo) | np.isnan(hi))
        lo, hi = lo[keep], hi[keep]
        if lo.size:
            out["int_min"], out["int_max"] = float(lo.min()), float(hi.max())
            out["fits"] = {f"int{b}": float(((lo >= -2 ** (b - 1))
                                             & (hi < 2 ** (b - 1))).mean())
                           for b in (8, 16, 32)}
    by_type = {}
    for r in rows:
        mtype = re.sub(r"_\d+$", "", r["layer"].rsplit("/", 1)[-1])
        by_type.setdefault(mtype, []).append(r)

    def agg(vals, fn):
        vals = [v for v in vals if not math.isnan(v)]
        return fn(vals) if vals else math.nan
    out["per_type"] = {
        t: {"n": len(rs),
            "scale_min": agg([r.get("scale_out", math.nan) for r in rs], min),
            "scale_max": agg([r.get("scale_out", math.nan) for r in rs], max),
            "int_min": agg([r.get("min_out_int", math.nan) for r in rs], min),
            "int_max": agg([r.get("max_out_int", math.nan) for r in rs], max)}
        for t, rs in sorted(by_type.items())}
    if rows and "shape_out" in rows[0]:
        out["shapes"] = Counter(r["shape_out"] for r in rows).most_common(10)
    if per_layer:
        out["per_layer"] = [{k: r.get(k) for k in ("layer", "scale_out", "min_out_int",
                                                   "max_out_int")} for r in rows]
    return out


def print_summary(s: dict):
    print(f"records: {s['records']}")
    if "int_min" in s:
        print(f"global int extrema: [{s['int_min']:.1f}, {s['int_max']:.1f}]")
        for name, frac in s["fits"].items():
            print(f"  fits {name}: {frac * 100:.1f}% of layers")
    print("\nper module type:")
    print(f"{'mtype':16s} {'n':>5s} {'scale_min':>12s} {'scale_max':>12s} "
          f"{'int_min':>12s} {'int_max':>12s}")
    for t, a in s["per_type"].items():
        print(f"{t:16s} {a['n']:5d} {a['scale_min']:12.4g} {a['scale_max']:12.4g} "
              f"{a['int_min']:12.1f} {a['int_max']:12.1f}")
    if "shapes" in s:
        print("\nshape histogram (top 10):")
        for shape, count in s["shapes"]:
            print(f"{shape:24s} {count}")
    if "per_layer" in s:
        print("\nper layer:")
        for r in s["per_layer"]:
            print(f"{r['layer']:40s} {r['scale_out']!s:>24s} "
                  f"{r['min_out_int']!s:>12s} {r['max_out_int']!s:>12s}")


def main(argv=None):
    p = argparse.ArgumentParser(description="IO-stats summary / engine envelope audit")
    p.add_argument("path", nargs="?")
    p.add_argument("--per-layer", action="store_true")
    p.add_argument("--engine", metavar="MODEL",
                   help="audit the integer engine for MODEL instead of "
                        "reading a sim io-stats dump")
    p.add_argument("--families", default="ivit,ivit,ivit",
                   help="gelu,softmax,ln families for --engine")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="where --engine runs: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    if args.engine:
        _, bad = engine_audit(args.engine, args.families, args.batch, args.device)
        return 1 if bad else 0
    if not args.path:
        p.error("path required unless --engine is given")
    print_summary(summarize(read_io_stats(args.path), args.per_layer))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
