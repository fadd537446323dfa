"""The benchmark finds every cell, configuration, traffic mix and metric by
name, and ``BENCHMARK.json`` keeps to its contract's shapes."""

import json
import os
import re
import shutil

import pytest

from gpubench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.benchmark()


def test_benchmark_json_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"img_per_s", "batch_p95_ms", "setup_s"} <= e2e
    assert {n.split(".")[0] for n in e2e} == {"img_per_s", "batch_p95_ms", "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert ("workloads" in m) == ("." in m["name"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "per_layer"])
def test_every_entry_resolves_by_name(bench, kind):
    for entry in bench[kind]:
        if kind == "configs":
            cfg = json.load(open(os.path.join(cells.ROOT, entry["file"])))
            assert entry["file"].startswith("gpubench/")
            assert cells.reference(cfg).forward
            assert entry["reduced"] == []
        elif kind == "workloads":
            w, cfg, traffic = cells.cell(entry["name"])
            assert w["chips"] == 1 and traffic["batch"] > 0 and cfg["arch"] in ("vit", "swin")
        else:
            mod = cells.metric(entry["name"])
            assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"],
                                                        entry["moves"])
            assert entry["moves"] == "img_per_s"
            assert set(entry["workloads"]) <= {w["name"] for w in bench["workloads"]}


def test_a_new_config_and_traffic_file_is_found_by_name(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(cells.ROOT, "gpubench"), root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.load(open(root / "gpubench/configs/deit_s_ibert.json"))
    cfg["depth"] = 3
    json.dump(cfg, open(root / "gpubench/configs/deit_s_cut.json", "w"))
    traffic = json.load(open(root / "gpubench/traffic/offline_b256.json"))
    traffic["batch"] = 8
    json.dump(traffic, open(root / "gpubench/traffic/offline_b8.json", "w"))
    new = dict(bench)
    new["configs"] = bench["configs"] + [{**bench["configs"][0], "name": "deit_s_cut",
                                          "file": "gpubench/configs/deit_s_cut.json"}]
    new["workloads"] = bench["workloads"] + [{**bench["workloads"][0],
                                              "name": "deit_s_cut.offline_b8",
                                              "config": "deit_s_cut",
                                              "traffic": "offline_b8"}]
    json.dump(new, open(root / "BENCHMARK.json", "w"))
    w, cfg, traffic = cells.cell("deit_s_cut.offline_b8", root=str(root))
    assert cfg["depth"] == 3 and traffic["batch"] == 8
    assert [m["name"] for m in cells.cell_metrics("deit_s_cut.offline_b8", "end_to_end",
                                                  str(root))] == ["img_per_s", "batch_p95_ms",
                                                                  "setup_s"]
    with pytest.raises(KeyError):
        cells.cell("deit_s_cut.nothing", root=str(root))


@pytest.mark.parametrize("change", [{"loop": "open"}, {"images_on": "disk"}, {"batch": None}],
                         ids=["unknown_key", "unknown_place", "missing_key"])
def test_a_traffic_file_the_harness_cannot_run_is_refused(tmp_path, bench, change):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(cells.ROOT, "gpubench"), root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.load(open(root / "gpubench/traffic/offline_b256.json"))
    traffic = {k: v for k, v in {**traffic, **change}.items() if v is not None}
    json.dump(traffic, open(root / "gpubench/traffic/offline_b256.json", "w"))
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    with pytest.raises(ValueError):
        cells.cell("deit_s_ibert.offline_b256", root=str(root))
