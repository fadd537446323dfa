"""Everything the harness finds by name: ``BENCHMARK.json``'s cells, each
configuration's file and plain reference, each traffic mix, each per-layer
metric's reader.  A later cell, configuration, mix or metric is a new file
and a new entry there; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what a traffic mix states, every key required: the harness runs a closed
# loop with one batch in flight, and a mix that asks for anything else is
# refused rather than run as that loop
TRAFFIC_KEYS = frozenset({"batch", "pool_batches", "images_on", "warmup_calls",
                          "check_batches", "check_rows_per_block", "trace_batches"})
IMAGES_ON = ("device", "host")


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(name, root=ROOT):
    """(workload entry, config dict, traffic dict) of the cell ``name``."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(root, "gpubench", "traffic", w["traffic"] + ".json"))
    if set(traffic) != TRAFFIC_KEYS or traffic["images_on"] not in IMAGES_ON:
        raise ValueError(f"traffic {w['traffic']!r} has the keys {sorted(traffic)}; the "
                         f"harness reads exactly {sorted(TRAFFIC_KEYS)}, with images_on "
                         f"one of {IMAGES_ON}")
    return w, config, traffic


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config):
    """The configuration's plain reference module (its ``reference`` file,
    a module of the benchmark's package)."""
    return importlib.import_module(config["reference"][:-len(".py")].replace("/", "."))


def metric(name, root=ROOT):
    """The per-layer metric ``name``: its module, with ``LAYER``, ``UNIT``,
    ``MOVES`` and ``read(run)``."""
    return load_module(os.path.join(root, "gpubench", "metrics", name + ".py"),
                       "gpubench_metric_" + name.replace(".", "_"))


def cell_metrics(workload, kind, root=ROOT):
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in benchmark(root)[kind]
            if "workloads" not in m or workload in m["workloads"]]
