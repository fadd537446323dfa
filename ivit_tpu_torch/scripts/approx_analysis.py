"""Approximation-error analysis of the integer families (counterpart of
``scripts/approx_analysis.py``), on the card by default.

Evaluates each family's GELU, softmax, exp and LayerNorm through the port's
cores (``ops/ivit.py``, ``ops/ibert.py``, ``ops/ppoly.py``,
``models/layers.py::IBERTSoftmax``) on ``--device`` against the float golden
function over JAX's grids, and reports max / mean / median absolute error:

* GELU: the dense 8-bit grid ``[-128, 127] * scale``;
* softmax: 64 seeded rows of 197 scores on that grid;
* exp: ``x_int`` from -512 to 0;
* LayerNorm: seeded [4, 16, 192] rows on that grid.

The goldens are computed on the host, as JAX's are: GELU through
``scipy.special.erf``, exp and LayerNorm by JAX's numpy expressions, the
softmax in f32 numpy (JAX's takes ``jax.nn.softmax``: its statistics may
differ from these in the last ulps).

    python -m ivit_tpu_torch.scripts.approx_analysis --function gelu --scale 0.05
    python -m ivit_tpu_torch.scripts.approx_analysis --function all \\
        --families ivit ibert ppoly ibert_int_sqrt --device cpu --json out.json

``outputs(function, scale, families, device)`` returns each family's
outputs (numpy, before the statistics) and the golden; ``main(argv)``
returns the statistics it prints.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

FUNCTIONS = ("gelu", "softmax", "exp", "layernorm")


def _err_stats(got, want):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return {"max_err": float(err.max()), "mean_err": float(err.mean()),
            "median_err": float(np.median(err))}


def _host(t):
    return t.detach().cpu().numpy()


def _scale(scale, dev):
    return torch.tensor([scale], dtype=torch.float32, device=dev)


def gelu_outputs(scale, families, dev):
    from scipy.special import erf

    from ivit_tpu_torch.ops import ibert, ivit, ppoly

    x = (np.arange(-128, 128) * scale).astype(np.float32).reshape(1, -1)
    ref = x * 0.5 * (1 + erf(x / np.sqrt(2)))
    xt, s = torch.from_numpy(x).to(dev), _scale(scale, dev)
    out = {}
    for fam in families:
        if fam == "ivit":
            y, _ = ivit.shift_gelu(xt, s)
        elif fam == "ibert":
            y, _ = ibert.ibert_gelu(xt, s)
        elif fam.startswith("ppoly"):
            table = ppoly.fit_gelu_table(float(x.min()), float(x.max()), scale,
                                         backend="float")
            y_int = ppoly.eval_piecewise_poly(
                torch.from_numpy(x / scale).to(dev), table.bounds.astype(np.float32),
                table.coeffs.astype(np.float32))
            y = y_int / 2.0**table.scale_bits
        else:
            continue
        out[fam] = _host(y)
    return out, ref


def softmax_outputs(scale, families, dev, n=197):
    from ivit_tpu_torch.models.layers import IBERTSoftmax
    from ivit_tpu_torch.ops import ivit

    rng = np.random.default_rng(0)
    x = (rng.integers(-127, 128, size=(64, n)) * scale).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    ref = e / e.sum(-1, keepdims=True)
    xt, s = torch.from_numpy(x).to(dev), _scale(scale, dev)
    out = {}
    for fam in families:
        if fam == "ivit":
            y, _ = ivit.shiftmax(xt, s)
        elif fam == "ibert":
            mod = IBERTSoftmax(output_bit=8).to(dev)
            with torch.no_grad():
                # JAX's init pass, then its running_stat pass (:77-81): the
                # first sets the exp range, the second takes its EMA
                for _ in range(2):
                    mod(xt, s, running_stat=True)
                y, _ = mod(xt, s, running_stat=False)
        else:
            continue
        out[fam] = _host(y)
    return out, ref


def exp_outputs(scale, families, dev):
    from ivit_tpu_torch.ops import ibert, ivit

    x_int = np.arange(-512, 1, dtype=np.float32)
    ref = np.exp(x_int * scale)
    xt = torch.from_numpy(x_int).to(dev)
    s = torch.tensor(scale, dtype=torch.float32, device=dev)
    out = {}
    for fam in families:
        if fam == "ivit":
            e, e_s = ivit.int_exp_shift(xt, s, n=15)
        elif fam == "ibert":
            e, e_s = ibert.int_exp(xt, s)
        else:
            continue
        out[fam] = _host(e) * float(_host(e_s).reshape(-1)[0])
    return out, ref


def layernorm_outputs(scale, families, dev, c=192):
    from ivit_tpu_torch.ops import ibert, ivit

    rng = np.random.default_rng(0)
    x = (rng.integers(-127, 128, size=(4, 16, c)) * scale).astype(np.float32)
    mean = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    ref = (x - mean) / np.sqrt(var + 1e-6)
    xt, s = torch.from_numpy(x).to(dev), _scale(scale, dev)
    w = torch.ones(c, device=dev)
    b = torch.zeros(c, device=dev)
    shift = torch.zeros(1, device=dev)
    out = {}
    for fam in families:
        if fam == "ivit":
            y, _, _ = ivit.i_layernorm(xt, s, w, b)
        elif fam in ("ibert", "ibert_int_sqrt"):
            y, _, _, _ = ibert.ibert_layernorm(xt, s, w, b, shift,
                                               overflow_handling=False,
                                               use_int_sqrt=fam == "ibert_int_sqrt")
        else:
            continue
        out[fam] = _host(y)
    return out, ref


_OUTPUTS = {"gelu": gelu_outputs, "softmax": softmax_outputs, "exp": exp_outputs,
            "layernorm": layernorm_outputs}


def outputs(function, scale, families, device=None):
    """``({family: outputs}, golden)`` of one function on ``device``
    (default ``cuda``; raises without a card unless ``"cpu"``)."""
    from ivit_tpu_torch import resolve_device
    return _OUTPUTS[function](scale, families, resolve_device(device))


def analyze(function, scale, families, device=None):
    """``{family: {"max_err", "mean_err", "median_err"}}`` of one function."""
    out, ref = outputs(function, scale, families, device)
    return {fam: _err_stats(y, ref) for fam, y in out.items()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Approximation-error analysis "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--function", default="all", choices=list(FUNCTIONS) + ["all"])
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--families", nargs="+", default=["ivit", "ibert", "ppoly"])
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the cores run: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    which = list(FUNCTIONS) if args.function == "all" else [args.function]
    results = {}
    for name in which:
        results[name] = analyze(name, args.scale, args.families, args.device)
        for fam, stats in results[name].items():
            print(f"{name:10s} {fam:10s} max {stats['max_err']:.5f} "
                  f"mean {stats['mean_err']:.5f} "
                  f"median {stats['median_err']:.5f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
