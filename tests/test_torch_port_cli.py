"""The port's inference, engine-inference, serving-bench, IO-analysis and
training CLIs (``ivit_tpu_torch/scripts``), in-process on the CPU.

The registry's model names build the 64 px, depth-2 DeiT of ``ARCH``
(``str2model`` monkeypatched, as ``test_torch_port_trainer.py`` does);
JAX's CLIs are not run (they train or init first): the JAX side is its
exporter, loader pieces, freeze, ``save_engine`` and engine, called
in-process.

* ``inference.main`` on a checkpoint JAX's ``save_reference_checkpoint``
  wrote: its exported artifact byte-equal to JAX's ``save_engine`` of
  JAX's ``freeze_model`` of the variables JAX's loader reads from the file
  (the clock frozen: the ``.npz``'s zip headers carry it); its top-1/3/5
  counts those of JAX's engine on the same synthetic batches; its IO-stats
  CSV one row per ``(tensor, scale)`` site; with ``--calibration-batches
  1`` the artifact equals the freeze of the port's sim recalibrated on the
  same batch; ``--engine sim`` gives the same counts;
* ``engine_inference.main`` on that artifact, plain and ``--serve``: the
  inference CLI's counts;
* ``serving_bench.main`` with a handful of requests: JAX's keys (the card's
  name in place of the backend, no tunnel note), every overload point's
  counts adding up to the offered load;
* ``analyze_io_stats.main`` on the CSV (its numbers pandas'), and its
  ``--engine`` audit on the CPU: no hard-bound violation;
* ``quant_train --pretrained`` with a timm-style float file: the loaded
  leaves equal JAX's loader's, the sim trains a step to a finite loss;
  ``--mesh-dp`` and ``--distributed`` still refuse.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_compat import _jax_load, _keys, _model_config, _template  # noqa: E402

from ivit_tpu.compat import export_torch as jexp  # noqa: E402
from ivit_tpu.engine import freeze_model as jax_freeze  # noqa: E402
from ivit_tpu.engine.export import save_engine as jax_save  # noqa: E402
from ivit_tpu.engine.vit_int import engine_forward as jax_forward  # noqa: E402
from ivit_tpu.models import VisionTransformer as JaxViT  # noqa: E402
import ivit_tpu_torch.models as tmodels  # noqa: E402
from ivit_tpu_torch.compat import torch_ckpt as tckpt  # noqa: E402
from ivit_tpu_torch.engine.export import save_engine  # noqa: E402
from ivit_tpu_torch.engine.freeze import freeze_model  # noqa: E402
from ivit_tpu_torch.models import VisionTransformer  # noqa: E402
from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy  # noqa: E402
from ivit_tpu_torch.models.vit_float import (FloatVisionTransformer,  # noqa: E402
                                             timm_state_dict)
from ivit_tpu_torch.scripts import (analyze_io_stats, engine_inference,  # noqa: E402
                                    inference, quant_train, serving_bench)
from ivit_tpu_torch.train import trainer as ttrainer  # noqa: E402
from ivit_tpu_torch.train.data import SyntheticDataset, data_loader  # noqa: E402
from ivit_tpu_torch.utils import iostats as tio  # noqa: E402

ARCH = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2)
FAM = ("ibert", "ibert", "ibert")
BATCH, BATCHES = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards: Tier-1 runs six
    workers at once (the integer paths' bits do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small_models(monkeypatch):
    """Every registered name builds the 64 px depth-2 DeiT of ``ARCH``."""
    def factory(name):
        return lambda **kw: VisionTransformer(**{**ARCH, "img_size": 64, **kw})
    monkeypatch.setattr(tmodels, "str2model", factory)
    monkeypatch.setattr(ttrainer, "str2model", factory)


def _sim(seed=0):
    sim = VisionTransformer(img_size=64, num_classes=10, gelu_type=FAM[0],
                            softmax_type=FAM[1], layernorm_type=FAM[2], device="cpu",
                            seed=seed, **ARCH)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _ in range(2):
            sim(torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32)),
                running_stat=True)
    return sim


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference ``.pth.tar`` written by JAX's exporter from a calibrated
    sim, the variables JAX's loader reads back, and the directory."""
    root = tmp_path_factory.mktemp("cli")
    sim = _sim()
    cfg = _model_config(*FAM, "8")
    path = str(root / "ckpt.pth.tar")
    jexp.save_reference_checkpoint(variables_to_numpy(sim), cfg, path)
    variables, _ = _jax_load(path, _template(sim))
    return path, variables, root


def _argv(path, *extra):
    return ["--weights", path, "--dataset", "synthetic", "--batch-size", str(BATCH),
            "--max-batches", str(BATCHES), "--img-size", "64", "--num-classes", "10",
            "--device", "cpu", *extra]


def _eval_batches(seed=1):
    ds = SyntheticDataset(n=8 * BATCH, num_classes=10, img_size=64, seed=seed)
    return [b for _, b in zip(range(BATCHES),
                              data_loader(ds, BATCH, train=False, img_size=64,
                                          drop_last=True))]


def _counts(logits_and_labels):
    top = np.zeros(3, np.int64)
    for logits, labels in logits_and_labels:
        order = np.argsort(-np.asarray(logits), axis=-1)
        for j, k in enumerate((1, 3, 5)):
            top[j] += (order[:, :k] == labels[:, None]).any(-1).sum()
    return top


@pytest.fixture(scope="module")
def cli_run(ckpt, tmp_path_factory):
    """The inference CLI on JAX's file, no recalibration: (result, artifact
    path, CSV path, JAX's artifact path)."""
    path, variables, root = ckpt
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tmodels, "str2model", lambda name: lambda **kw: VisionTransformer(
            **{**ARCH, "img_size": 64, **kw}))
        mp.setattr(time, "time", lambda: 1.7e9)
        eng, csv = str(root / "eng.npz"), str(root / "io.csv")
        result = inference.main(_argv(path, "--export-engine", eng, "--io-stats", csv))
        jspec = jax_freeze(JaxViT(img_size=64, num_classes=10, gelu_type=FAM[0],
                                  softmax_type=FAM[1], layernorm_type=FAM[2], **ARCH),
                           variables)
        jax_save(jspec, str(root / "jax_eng.npz"))
    finally:
        mp.undo()
    return result, eng, csv, str(root / "jax_eng.npz"), jspec


def test_inference_cli_artifact_and_counts_match_jax(cli_run):
    result, eng, _, jax_eng, jspec = cli_run
    for ext in (".npz", ".json"):
        a, b = eng[:-4] + ext, jax_eng[:-4] + ext
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), ext
    batches = _eval_batches()
    fwd = jax.jit(lambda a: jax_forward(jspec, a, pallas=False))
    want = _counts((fwd(jnp.asarray(b["image"])), b["label"]) for b in batches)
    n = BATCH * BATCHES
    assert result["images"] == n
    assert [round(result[k] * n) for k in ("top1", "top3", "top5")] == list(want)
    assert set(result) == {"top1", "top3", "top5", "images", "ms_per_batch",
                           "ms_per_image", "images_per_sec"}


def test_inference_cli_io_stats_csv(cli_run, ckpt):
    """One row per (tensor, scale) output of the sim's first-batch forward,
    the rows the port's ``attach_io_stats`` records for that batch."""
    _, _, csv, _, _ = cli_run
    rows = pd.read_csv(csv, float_precision="round_trip")
    sim = VisionTransformer(img_size=64, num_classes=10, gelu_type=FAM[0],
                            softmax_type=FAM[1], layernorm_type=FAM[2], device="cpu",
                            seed=1, **ARCH)
    tckpt.load_into_model(sim, ckpt[0])
    tio.clear_io_stats()
    tio.attach_io_stats(sim)(torch.from_numpy(_eval_batches()[0]["image"]))
    want = tio.get_io_stats()
    assert list(rows["layer"]) == [r["layer"] for r in want]
    np.testing.assert_array_equal(rows["max_out"].to_numpy(), [r["max_out"] for r in want])


def test_inference_cli_recalibrates_as_the_sim(ckpt, tmp_path, monkeypatch):
    """``--calibration-batches 1``: the artifact is the freeze of the port's
    sim loaded from the file and calibrated on the CLI's first calibration
    batch; ``--engine sim`` counts as the engine does on the frozen sim."""
    path, _, _ = ckpt
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    eng = str(tmp_path / "recal.npz")
    result = inference.main(_argv(path, "--calibration-batches", "1",
                                  "--export-engine", eng))
    sim = VisionTransformer(img_size=64, num_classes=10, gelu_type=FAM[0],
                            softmax_type=FAM[1], layernorm_type=FAM[2], device="cpu",
                            seed=7, **ARCH)
    tckpt.load_into_model(sim, path)
    cal = SyntheticDataset(n=8 * BATCH, num_classes=10, img_size=64, seed=2)
    batch = next(data_loader(cal, BATCH, train=True, img_size=64))
    with torch.no_grad():
        sim(torch.from_numpy(batch["image"]), running_stat=True)
    save_engine(freeze_model(sim), str(tmp_path / "want"))
    for ext in (".npz", ".json"):
        assert ((tmp_path / f"recal{ext}").read_bytes()
                == (tmp_path / f"want{ext}").read_bytes()), ext
    sim_result = inference.main(_argv(path, "--calibration-batches", "1",
                                      "--engine", "sim"))
    assert sim_result["images"] == result["images"]
    with torch.no_grad():
        want = _counts((sim(torch.from_numpy(b["image"])), b["label"])
                       for b in _eval_batches())
    n = BATCH * BATCHES
    assert [round(sim_result[k] * n) for k in ("top1", "top3", "top5")] == list(want)


def test_engine_inference_cli_plain_and_served(cli_run):
    result, eng, _, _, _ = cli_run
    argv = ["--engine", eng, "--dataset", "synthetic", "--batch-size", str(BATCH),
            "--max-batches", str(BATCHES), "--device", "cpu"]
    plain = engine_inference.main(argv)
    served = engine_inference.main(argv + ["--serve"])
    for got in (plain, served):
        assert got["images"] == result["images"]
        assert (got["top1"], got["top5"]) == (result["top1"], result["top5"])
    assert {"ms_per_batch", "images_per_sec"} <= set(plain)
    assert {"latency_ms_p50", "latency_ms_p95", "batches"} <= set(served)
    assert served["images"] == BATCH * BATCHES


def test_serving_bench_cli(tmp_path):
    out = str(tmp_path / "serving.json")
    result = serving_bench.main(["--device", "cpu", "--requests", "8",
                                 "--batches", "1,4", "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(result))
    jax_keys = {"model", "families", "backend", "device", "requests_per_point",
                "points", "raw_engine_b64_img_s", "path_choice", "transfer_note",
                "overload_ab"}
    assert set(result) == jax_keys - {"backend", "transfer_note"} | {"card"}
    assert result["card"] == "cpu" and result["raw_engine_b64_img_s"] > 0
    assert [p["batch_size"] for p in result["points"]] == [1, 4]
    for p in result["points"]:
        assert p["images"] == 8 and {"wall_s", "throughput_img_s", "latency_ms_p95"} <= set(p)
    assert [p["mode"] for p in result["overload_ab"]] == ["unbounded", "bounded"]
    for p in result["overload_ab"]:
        assert p["served"] + p["rejected"] + p["shed"] == p["offered"] == 256
    assert result["overload_ab"][1]["max_queue"] == 64


def test_analyze_io_stats_cli(cli_run, capsys):
    _, _, csv, _, _ = cli_run
    assert analyze_io_stats.main([csv, "--per-layer"]) == 0
    text = capsys.readouterr().out
    df = pd.read_csv(csv, float_precision="round_trip")
    s = analyze_io_stats.summarize(analyze_io_stats.read_io_stats(csv))
    assert s["records"] == len(df) and f"records: {len(df)}" in text
    ints = df[["min_out_int", "max_out_int"]].dropna()
    assert (s["int_min"], s["int_max"]) == (ints.min_out_int.min(), ints.max_out_int.max())
    for bits in (8, 16, 32):
        lim = 2 ** (bits - 1)
        frac = ((ints.min_out_int >= -lim) & (ints.max_out_int < lim)).mean()
        assert s["fits"][f"int{bits}"] == pytest.approx(frac, abs=0)
    df["mtype"] = df["layer"].str.rsplit("/", n=1).str[-1].str.replace(r"_\d+$", "", regex=True)
    g = df.groupby("mtype").agg(n=("layer", "count"), scale_max=("scale_out", "max"))
    for t, a in s["per_type"].items():
        assert a["n"] == g.loc[t, "n"]
        assert a["scale_max"] == g.loc[t, "scale_max"] or np.isnan(g.loc[t, "scale_max"])
    with pytest.raises(ValueError, match="CSV only"):
        analyze_io_stats.read_io_stats("io.pkl")


def test_analyze_io_stats_engine_audit(capsys):
    assert analyze_io_stats.main(["--engine", "deit_small_patch16_224", "--families",
                                  "ibert,ibert,ibert", "--batch", "2",
                                  "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "hard-bound violations: 0" in text and "exp_sum#" in text


def test_quant_train_pretrained(tmp_path):
    fm = FloatVisionTransformer(img_size=64, num_classes=10, device="cpu", seed=3, **ARCH)
    path = str(tmp_path / "deit_timm.pth")
    torch.save({"model": timm_state_dict(fm)}, path)
    argv = ["--dataset", "synthetic", "--synthetic-samples", "8", "--batch-size", "4",
            "--img-size", "64", "--num-classes", "10", "--epochs", "1", "--aa", "none",
            "--calibration-batches", "1", "--device", "cpu", "--run-id", "t",
            "--output-dir", str(tmp_path / "runs"), "--pretrained", path,
            "--layer-type", "ibert"]
    trainer = quant_train.build_trainer(quant_train.parse_args(argv))
    sim = trainer.model
    fresh = VisionTransformer(img_size=64, num_classes=10, gelu_type="ibert",
                              softmax_type="ibert", layernorm_type="ibert", device="cpu",
                              seed=0, **ARCH)
    template = _template(fresh)
    want, report = _jax_load(path, template)
    got = variables_to_numpy(sim)
    assert differing_leaves(got["params"], want["params"]) == []
    # the float file holds every parameter and no quantization leaf
    assert report["missing"] == [".".join(k) for k in _keys(template["quant_stats"])]
    # the train state holds the loaded tensors
    assert torch.equal(trainer.state["params"]["blocks_0"]["attn"]["qkv"]["kernel"],
                       sim.blocks[0].attn.qkv.kernel)
    trainer.fit()
    losses = [json.loads(line)["loss"] for line in
              open(os.path.join(str(tmp_path / "runs"), "log_t.jsonl"))
              if json.loads(line)["phase"] == "train"]
    assert losses and np.isfinite(losses).all()
    for flag in (["--mesh-dp", "2"], ["--distributed"]):
        with pytest.raises(NotImplementedError):
            quant_train.build_trainer(quant_train.parse_args(argv[:-4] + flag))


def test_benchmarking_utils():
    """``utils/benchmarking.py`` on the CPU: ``sol_table`` is JAX's, the
    timers return seconds per call, ``chip_peaks`` refuses a machine
    without an H100 entry (here: no card)."""
    from ivit_tpu.utils import benchmarking as jbench
    from ivit_tpu_torch.utils import benchmarking as tbench
    ops = {"attn_block_core": {"us_per_iter": 347.0, "calls_per_iter": 12.0},
           "mlp_wgmma_kernel": {"us_per_iter": 510.5, "calls_per_iter": 12.0},
           "elementwise": {"us_per_iter": 12.25, "calls_per_iter": 40.0}}
    sites = {"attn": (["attn"], 74.8e9), "mlp": (["mlp", "gelu"], 119.0e9),
             "none": (["nothing"], 1e9)}
    table = tbench.sol_table(ops, sites, 1979e12)
    assert table == jbench.sol_table(ops, sites, 1979e12)
    assert set(table) == {"attn", "mlp", "_unmatched_us"}
    x = torch.ones(64, 64)
    assert tbench.time_inloop(lambda c: c * 1.0001, x, n_iters=5, n_timings=2) > 0
    assert tbench.time_dispatch(lambda a: a @ a, x, iters=3) > 0
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError, ValueError)):
            tbench.chip_peaks()
