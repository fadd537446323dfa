"""Experiment grid sweep runner (counterpart of ``scripts/sweep.py``), the
points on the card by default.

Reads a YAML or JSON sweep config with a ``grid`` of parameter lists
(PyYAML where it imports, else a reader of the two-level subset sweep
configs use, :func:`_mini_yaml`: the card's installation does not promise
PyYAML), expands the
cartesian product in sorted key order, and runs the port's training CLI
once a point::

    python -m ivit_tpu_torch.scripts.quant_train --output-dir D --run-id R \\
        --<key> <value> ... --device <device> <extra>

from the repository root, whatever the caller's working directory (the
output directory is made absolute first; a relative path in ``--extra`` is
read from the repository root).  Each point's final epoch record (from its
``log_<run_id>.jsonl``) goes into ``sweep_summary.jsonl``, JAX's layout.

    python -m ivit_tpu_torch.scripts.sweep --config sweep.yaml --dry-run
    python -m ivit_tpu_torch.scripts.sweep --config sweep.yaml \\
        --output-dir runs/sweep1 --device cpu --extra --dataset synthetic

``main(argv)`` returns the summary records it wrote (with ``--dry-run``,
each point's ``point``, ``run_id`` and ``cmd``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_config(path):
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    try:
        import yaml  # type: ignore
        return yaml.safe_load(text)
    except ImportError:
        return _mini_yaml(text)


def _mini_yaml(text):
    """Parse the two-level mapping/list YAML of sweep configs: ``key:``
    opens a mapping, or a list where ``- item`` lines follow it, indented
    or not.  (JAX's reader, ``scripts/sweep.py:38-62``, nests an indented
    list one level too deep: ``sweep.yaml``'s grid comes out as
    ``{"bitwidth": {"bitwidth": [...]}, ...}``.)"""
    root: dict = {}
    stack = [(0, root)]            # (indent of a node's entries, node)
    last = None                    # (mapping, key) of the last key line
    for raw in text.splitlines():
        if not raw.strip() or raw.strip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip())
        line = raw.strip()
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        node = stack[-1][1]
        if line.startswith("- "):
            owner, key = last
            if not isinstance(owner[key], list):
                owner[key] = []
            owner[key].append(_coerce(line[2:]))
        elif line.endswith(":"):
            key = line[:-1].strip()
            node[key] = {}
            stack.append((indent + 2, node[key]))
            last = (node, key)
        else:
            key, _, value = line.partition(":")
            node[key.strip()] = _coerce(value.strip())
            last = (node, key.strip())
    return root


def _coerce(s):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s.strip("'\"")


def _grid(cfg):
    return cfg.get("grid", cfg.get("parameters", {}))


def points(cfg):
    """The grid's points in JAX's order, each ``(point, run_id)``."""
    grid = _grid(cfg)
    keys = sorted(grid)
    values = [grid[k] if isinstance(grid[k], list) else [grid[k]] for k in keys]
    out = []
    for combo in itertools.product(*values):
        point = dict(zip(keys, combo))
        run_id = "_".join(f"{k}-{v}" for k, v in point.items())[:80] \
            .replace("/", "-").replace(",", ".")
        out.append((point, run_id))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Sweep runner (PyTorch/CUDA port)")
    p.add_argument("--config", required=True)
    p.add_argument("--output-dir", default="runs/sweep")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="forwarded to every point: 'cuda' (default) or 'cpu'")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="extra args forwarded to quant_train")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.config)
    combos = points(cfg)
    print(f"{len(combos)} sweep points over {sorted(_grid(cfg))}")

    out_dir = os.path.abspath(args.output_dir)
    os.makedirs(out_dir, exist_ok=True)
    summary_path = os.path.join(out_dir, "sweep_summary.jsonl")
    records = []
    for i, (point, run_id) in enumerate(combos):
        cmd = [sys.executable, "-m", "ivit_tpu_torch.scripts.quant_train",
               "--output-dir", out_dir, "--run-id", run_id]
        for k, v in point.items():
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        cmd += ["--device", args.device] + args.extra
        print(f"[{i + 1}/{len(combos)}] {' '.join(cmd)}")
        if args.dry_run:
            records.append({"point": point, "run_id": run_id, "cmd": cmd})
            continue
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        rec = {"point": point, "run_id": run_id, "returncode": r.returncode}
        if r.returncode != 0:
            rec["stderr_tail"] = r.stderr[-2000:]
        # the final epoch record from the run's jsonl log
        log_path = os.path.join(out_dir, f"log_{run_id}.jsonl")
        if os.path.exists(log_path):
            with open(log_path) as f:
                epochs = [json.loads(line) for line in f
                          if '"phase": "epoch"' in line]
            if epochs:
                rec["final"] = epochs[-1]
        with open(summary_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        records.append(rec)
    print(f"summary -> {summary_path}")
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
