"""The plain reference against the program on the CPU, the control, and
the harness's check under planted faults."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from gpubench import cells, control, harness, program, specmaker
from gpubench.reference import common

# cut sizes a test run holds: the DeiT-S and Swin-T widths at a smaller image
# and depth
CUTS = {
    "deit_s_ibert.offline_b256": {"config": {"depth": 2, "img_size": 64},
                                  "traffic": {"batch": 4, "check_rows_per_block": 2,
                                              "trace_batches": 2}},
    "swin_t_ivit.offline_b64": {"config": {"depths": [2, 2], "stage_heads": [3, 6],
                                           "img_size": 56},
                                "traffic": {"batch": 2, "check_rows_per_block": 1,
                                            "trace_batches": 2}},
}
CUTS["deit_s_ibert.host_b256"] = CUTS["deit_s_ibert.offline_b256"]


def _cell(name, seed):
    _, cfg, _ = cells.cell(name)
    cfg = {**cfg, **CUTS[name]["config"]}
    spec_cfg, params = specmaker.make(cfg, seed)
    return cfg, spec_cfg, params


@pytest.mark.parametrize("name", ["deit_s_ibert.offline_b256", "swin_t_ivit.offline_b64"])
def test_reference_equals_the_engine_on_the_cpu(name):
    cfg, spec_cfg, params = _cell(name, 2**31 + 7)
    s = cfg["img_size"]
    x = torch.randn(3, s, s, 3, generator=torch.Generator().manual_seed(1))
    got = program.build(spec_cfg, params, "cpu")(x)
    want = cells.reference(cfg).forward(spec_cfg, common.tensors(params, "cpu"), x)
    assert torch.equal(got, want)
    assert float(want.std()) > 0


@pytest.mark.parametrize("name", ["deit_s_ibert.offline_b256", "swin_t_ivit.offline_b64"])
def test_the_int4_control_fails_the_check(name):
    lines = control.readings(name, [11, 12, 13], device="cpu", overrides=CUTS[name])
    assert all(line["control_gap_lsb"] > 0 for line in lines)


def _run(name, seed=3, wrap=None, trace=False):
    return harness.run_cell(name, seed, 0.3, trace, device="cpu", overrides=CUTS[name],
                            wrap_engine=wrap)


@pytest.mark.parametrize("name", sorted(CUTS))
def test_a_sound_run_is_correct_and_prints_its_checks(name):
    trace = name.startswith("swin")
    r = _run(name, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["max_logit_gap_lsb"] == {"value": 0.0, "limit": 0.0}
    wanted = {m["name"] for m in cells.cell_metrics(name, "per_layer" if trace else "end_to_end")}
    assert set(r["metrics"]) <= wanted
    if not trace:
        assert set(r["metrics"]) == wanted
        for m, v in r["metrics"].items():
            assert v == r["metrics"][m.split(".")[0]]


def _altered(engine):
    def call(x):
        out = engine(x).clone()
        out[0, 0] += 1e-3 * abs(float(out[0, 0])) + 1e-6
        return out
    return call


def _half_batch(engine):
    return lambda x: engine(x[: x.shape[0] // 2])


def _stale(engine):
    first = {}

    def call(x):
        if "out" not in first:
            first["out"] = engine(x)
        return first["out"]
    return call


@pytest.mark.parametrize("fault", [_altered, _half_batch, _stale],
                         ids=["answer_altered", "half_batch_left_out", "state_unchanged"])
@pytest.mark.parametrize("name", ["deit_s_ibert.offline_b256", "swin_t_ivit.offline_b64"])
def test_a_planted_fault_makes_the_run_incorrect(name, fault):
    r = _run(name, wrap=fault)
    assert r["correct"] is False
    assert r["checks"]["max_logit_gap_lsb"]["value"] > 0 and r["failed"] > 0


@pytest.mark.parametrize("images_on", ["device", "host"])
def test_every_batch_holds_new_images(images_on):
    traffic = {"batch": 4, "images_on": images_on}
    pool = torch.randn(2, 4, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    flat = pool.reshape(8, 8, 8, 3)
    feed = harness.Feed(torch, pool, traffic, 2**40 + 1, torch.device("cpu"))
    drawn, storages = [], set()
    try:
        for _ in range(2 * harness.Feed.RING):
            idx, x = feed.next()
            assert torch.equal(x, flat[idx]) and torch.equal(feed.images(idx, "cpu"), x)
            assert x.untyped_storage().data_ptr() != flat.untyped_storage().data_ptr()
            assert all(not torch.equal(x, y) for _, y in drawn)
            drawn.append((idx, x.clone()))
            storages.add(x.untyped_storage().data_ptr())
    finally:
        feed.close()
    if images_on == "host":
        assert len(storages) == harness.Feed.RING
    again = harness.Feed(torch, pool, traffic, 2**40 + 1, torch.device("cpu"))
    try:
        assert all(torch.equal(again.next()[0], idx) for idx, _ in drawn)
    finally:
        again.close()


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["ivit_tpu_torch", "ivit_tpu_torch.engine",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["ivit_tpu.engine", "jax.numpy", "flax",
                                      "optax", "jaxlib.xla"]) == [
        "flax", "ivit_tpu", "jax", "jaxlib", "optax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_and_the_yardstick_imports_no_program():
    base = os.path.join(cells.ROOT, "gpubench")
    for dirpath, _, files in os.walk(base):
        for f in files:
            if not f.endswith(".py") or "tests" in dirpath.split(os.sep):
                continue
            path = os.path.join(dirpath, f)
            found = set(_imports(path))
            assert not found & set(harness.FORBIDDEN), path
            if os.path.basename(path) != "program.py":
                assert "ivit_tpu_torch" not in found, path


def test_a_run_loads_no_jax_module():
    code = ("import json, sys; from gpubench import harness; "
            "from gpubench.tests.test_gpubench_reference import CUTS; "
            "harness.run_cell('deit_s_ibert.offline_b256', 1, 0.2, True, device='cpu', "
            "overrides=CUTS['deit_s_ibert.offline_b256'], log=open('/dev/null', 'w')); "
            "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.strip().splitlines()[-1]
    assert json.loads(out) == []


@pytest.mark.cuda
def test_cuda_a_cut_cell_is_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")
    for name in ("deit_s_ibert.offline_b256", "swin_t_ivit.offline_b64"):
        r = harness.run_cell(name, 5, 0.5, True, device="cuda", overrides=CUTS[name])
        assert r["correct"] is True
        assert r["metrics"]["launches_per_batch"]["value"] > 0
