"""The port's ``Trainer`` loop and training CLI against the JAX package's.

One ``fit()`` of each package's ``Trainer`` on the same 64 px ImageFolder
(4 classes, PNG and BMP files of 40-120 px): a depth-2 DeiT (both
trainer modules' ``str2model`` monkeypatched), JAX's initial variables
carried into the port's sim; the reference's augmentation
(``rand-m9-mstd0.5-inc1``), Mixup / CutMix with label smoothing, the EMA,
clip 1.0 and weight decay; two calibration batches, one epoch of two
steps.  The checks:

* the port's calibration (``Trainer.calibrate`` over the loader's
  batches) bitwise equal to an eager JAX calibration of the same batches.
  JAX's ``Trainer`` calibrates jitted, and under ``jit`` XLA:CPU contracts
  a residual range's ``x + identity`` into an FMA (ROADMAP Queue 3): its
  ranges are held within ``JIT_RANGE_ULPS`` ulps of the eager ones;
* the params after the epoch within ``tests/test_torch_port_train.py``'s
  bound of a step, summed over the steps: ``2 * lr_t`` each (Adam
  normalises, so a near-zero gradient whose sign differs moves a weight
  by up to ``2 * lr_t``); each logged loss within ``GRAD_RTOL`` of JAX's;
* the JSONL records with JAX's keys, in JAX's order of records;
* ``validate()``'s top-1 / top-5 equal on the same params and ranges, its
  loss within 1e-6 (the eval step's bound in ``test_torch_port_train.py``:
  the log-softmax sums in another order);
* the checkpoints readable both ways, and a resume that runs.

The CLI's ``main([...])`` runs on ``--dataset synthetic`` and on an
ImageFolder with ``--device cpu``; ``--pretrained``, ``--mesh-dp`` and
``--distributed`` raise.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.train import checkpoint as jckpt
from ivit_tpu.train import data as jdata
from ivit_tpu.train import steps as jsteps
from ivit_tpu.train import trainer as jtrainer
from ivit_tpu_torch.models import VisionTransformer
from ivit_tpu_torch.models.convert import (differing_leaves, variables_to_numpy,
                                           variables_to_torch)
from ivit_tpu_torch.scripts import quant_train
from ivit_tpu_torch.train import checkpoint as tckpt
from ivit_tpu_torch.train import data as tdata
from ivit_tpu_torch.train import optim
from ivit_tpu_torch.train import trainer as ttrainer
from ivit_tpu_torch.train.serialization import msgpack_restore

ARCH = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2)
LR = 1e-3
GRAD_RTOL = 1e-4
JIT_RANGE_ULPS = 2
CFG = dict(model="deit_tiny_patch16_224", img_size=64, num_classes=10, batch_size=8,
           epochs=1, lr=LR, weight_decay=0.05, clip_grad=1.0, model_ema=True,
           calibration_batches=2, run_id="t", log_interval=1, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards: Tier-1 runs six
    workers at once (the integer paths' bits do not depend on the thread
    count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small_models(monkeypatch):
    """Both trainers build the depth-2 64 px DeiT of ``ARCH``."""
    monkeypatch.setattr(jtrainer, "str2model", lambda name: lambda **kw: JaxViT(**ARCH, **kw))
    monkeypatch.setattr(ttrainer, "str2model",
                        lambda name: lambda **kw: VisionTransformer(**ARCH, **kw))


def _write_folder(root, per_class, seed):
    rng = np.random.default_rng(seed)
    for c in range(4):
        os.makedirs(os.path.join(root, f"c{c}"))
        for k in range(per_class):
            h, w = (int(v) for v in rng.integers(40, 120, 2))
            grid = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
            img = np.repeat(np.repeat(grid, 8, 0), 8, 1)[:h, :w]
            img = np.clip(img + rng.integers(-10, 11, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, f"c{c}",
                                                   f"{k}.{'bmp' if k == 1 else 'png'}"))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    _write_folder(str(root / "train"), 4, 0)
    _write_folder(str(root / "val"), 2, 1)
    return str(root)


def test_train_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jtrainer.TrainConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ttrainer.TrainConfig)]
    assert tf == [f for f in jf if f[0] not in ("mesh_dp", "mesh_tp")]
    cfg = dict(model="deit_small_patch16_224", bitwidth="8,8,8,8,16,8,16,8")
    assert (ttrainer.TrainConfig(**cfg).model_config()
            == jtrainer.TrainConfig(**cfg).model_config())


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _max_ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))


@pytest.fixture(scope="module")
def fitted(folder, tmp_path_factory):
    """Both trainers fitted once (module scope: the JAX compiles are most of
    this file's time); the port's calibration snapshot and an eager JAX
    calibration of the same batches."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, "str2model", lambda name: lambda **kw: JaxViT(**ARCH, **kw))
    mp.setattr(ttrainer, "str2model", lambda name: lambda **kw: VisionTransformer(**ARCH, **kw))
    # the Pillow-equal eval path in both packages (JAX's native one is used
    # only where `make -C native` has built its library)
    mp.setattr(jdata, "_native_preproc", lambda: None)
    mp.setattr(tdata, "_native_preproc", lambda: None)
    out = str(tmp_path_factory.mktemp("runs"))
    jcfg = jtrainer.TrainConfig(**CFG, output_dir=os.path.join(out, "jax"))
    tcfg = ttrainer.TrainConfig(**CFG, output_dir=os.path.join(out, "port"))
    ds = [jdata.ImageFolderDataset(os.path.join(folder, s)) for s in ("train", "val")]
    jtr = jtrainer.Trainer(jcfg, *ds)
    ttr = ttrainer.Trainer(tcfg, *(tdata.ImageFolderDataset(os.path.join(folder, s))
                                   for s in ("train", "val")), device="cpu")
    init = jax.device_get({"params": jtr.state["params"],
                           "quant_stats": jtr.state["quant_stats"]})
    variables_to_torch(ttr.model, init)
    ttr.ema_params = ttrainer.init_ema(ttr.state["params"])

    # eager JAX over the calibration batches of the loader
    calib = jdata.data_loader(jtr.ds_train, jcfg.batch_size, train=True, img_size=64,
                              seed=jcfg.seed + 999, rand_augment=jtr.rand_augment)
    qs = init["quant_stats"]
    for _, batch in zip(range(jcfg.calibration_batches), calib):
        qs = jsteps.make_calibration_step(jtr.model)(init["params"], qs, batch["image"])
    snaps = {"eager": jax.device_get(qs)}

    def snapshot(tr, key, get):
        calibrate = tr.calibrate

        def run():
            calibrate()
            snaps[key] = get()
        tr.calibrate = run
    snapshot(jtr, "jax", lambda: jax.device_get(jtr.state["quant_stats"]))
    snapshot(ttr, "port", lambda: variables_to_numpy(ttr.model)["quant_stats"])
    jbest, tbest = jtr.fit(), ttr.fit()
    yield dict(jtr=jtr, ttr=ttr, snaps=snaps, out=out, best=(jbest, tbest))
    mp.undo()


def test_fit_calibration_matches_eager_jax(fitted):
    snaps = fitted["snaps"]
    assert differing_leaves(snaps["port"], snaps["eager"]) == []
    worst = max(_max_ulps(a, b) for (_, a), (_, b) in zip(_leaves(snaps["jax"]),
                                                          _leaves(snaps["eager"])))
    assert worst <= JIT_RANGE_ULPS


def test_fit_params_and_losses_match_jax(fitted):
    jtr, ttr = fitted["jtr"], fitted["ttr"]
    steps = int(ttr.state["step"])
    assert steps == int(jtr.state["step"]) == 2
    bound = 2 * sum(float(jtr.schedule(i)) for i in range(steps))
    want = dict(_leaves(jax.device_get(jtr.state["params"])))
    got = dict(_leaves(variables_to_numpy(ttr.model)["params"]))
    assert want.keys() == got.keys()
    for path, w in want.items():
        tol = bound + 2 * np.spacing(np.abs(w).max())
        assert np.abs(got[path] - w).max() <= tol, path
    jema = dict(_leaves(jax.device_get(jtr.ema_params)))
    tema = dict(_leaves(optim.tree_map(lambda t: t.detach().numpy(), ttr.ema_params)))
    for path, w in jema.items():
        assert np.abs(tema[path] - w).max() <= bound + 2 * np.spacing(np.abs(w).max()), path
    jrec = _records(os.path.join(fitted["out"], "jax", "log_t.jsonl"))
    trec = _records(os.path.join(fitted["out"], "port", "log_t.jsonl"))
    assert [list(r) for r in trec] == [list(r) for r in jrec]
    for t, j in zip(trec, jrec):
        assert t["phase"] == j["phase"] and t["epoch"] == j["epoch"]
        if t["phase"] == "train":
            assert t["step"] == j["step"] and t["acc"] == j["acc"]
            assert abs(t["loss"] - j["loss"]) <= GRAD_RTOL * abs(j["loss"])


def test_validate_matches_jax_on_same_variables(fitted):
    jtr, ttr = fitted["jtr"], fitted["ttr"]
    variables_to_torch(ttr.model, jax.device_get(
        {"params": jtr.state["params"], "quant_stats": jtr.state["quant_stats"]}))
    got, want = ttr.validate(), jtr.validate()
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])


def test_checkpoints_read_both_ways_and_resume(fitted, folder):
    jtr, ttr, out = fitted["jtr"], fitted["ttr"], fitted["out"]
    port_ckpt = os.path.join(out, "port", "checkpoint_t")
    jax_ckpt = os.path.join(out, "jax", "checkpoint_t")
    assert os.path.exists(os.path.join(out, "port", "best", "meta.json"))
    # the port's checkpoint into JAX's state
    template = dict(jtr.state, ema_params=jtr.ema_params)
    state, meta = jckpt.load_checkpoint(port_ckpt, template)
    assert meta["epoch"] == 0 and int(state["step"]) == 2
    with open(os.path.join(port_ckpt, "state.msgpack"), "rb") as f:
        raw = msgpack_restore(f.read())
    assert differing_leaves(serialization.to_state_dict(jax.device_get(state)), raw) == []
    # JAX's checkpoint into the port's state
    tcfg = dataclasses.replace(ttr.cfg, epochs=2, resume=jax_ckpt,
                               output_dir=os.path.join(out, "resumed"))
    ds = [tdata.ImageFolderDataset(os.path.join(folder, s)) for s in ("train", "val")]
    resumed = ttrainer.Trainer(tcfg, *ds, device="cpu")
    assert resumed.start_epoch == 1 and int(resumed.state["step"]) == 2
    assert differing_leaves(variables_to_numpy(resumed.model)["params"],
                            jax.device_get(jtr.state["params"])) == []
    assert differing_leaves(tckpt.state_dict(resumed.state)["opt_state"],
                            serialization.to_state_dict(
                                jax.device_get(jtr.state["opt_state"]))) == []
    resumed.fit()
    assert int(resumed.state["step"]) == 4
    recs = _records(os.path.join(out, "resumed", "log_t.jsonl"))
    assert [r["epoch"] for r in recs if r["phase"] == "epoch"] == [1]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_cli_runs_synthetic_and_image_folder(tmp_path, folder):
    common = ["--batch-size", "4", "--epochs", "1", "--img-size", "64",
              "--calibration-batches", "1", "--device", "cpu", "--run-id", "cli",
              "--log-interval", "1"]
    tr = quant_train.main(["--dataset", "synthetic", "--synthetic-samples", "8",
                           "--output-dir", str(tmp_path / "syn"), "--aa", "none",
                           "--layer-type", "ibert", *common])
    assert tr.device.type == "cpu" and tr.cfg.gelu_type == "ibert"
    assert tr.cfg.num_classes == 10 and int(tr.state["step"]) == 2
    tr = quant_train.main(["--data-path", folder, "--output-dir", str(tmp_path / "img"),
                           "--model-ema", *common])
    assert tr.cfg.num_classes == 4 and tr.cfg.aa == "rand-m9-mstd0.5-inc1"
    assert int(tr.state["step"]) == 4
    assert os.path.exists(tmp_path / "img" / "checkpoint_cli" / "state.msgpack")
    assert quant_train.parse_args([]).device == "cuda"
    for flag in (["--mesh-dp", "2"], ["--distributed"]):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            quant_train.main(["--dataset", "synthetic", *flag, *common])
    # --pretrained loads the file (tests/test_torch_port_cli.py): a missing
    # one is an error of the file, not of the flag
    with pytest.raises(FileNotFoundError, match="w.pth"):
        quant_train.main(["--dataset", "synthetic", "--pretrained",
                          str(tmp_path / "w.pth"), "--output-dir", str(tmp_path / "pre"),
                          *common])


def test_soft_targets_are_f32():
    """numpy's CutMix targets are f64; the step takes them in f32, as JAX's
    ``jnp.asarray`` does (an f64 target made the loss and its gradient
    f64)."""
    from ivit_tpu_torch.train.steps import _batch
    sim = VisionTransformer(device="cpu", **ARCH, img_size=64, num_classes=10)
    images = np.zeros((2, 64, 64, 3), np.float32)
    soft = np.full((2, 10), 0.1, np.float64)
    _, label = _batch(sim, {"image": images, "label": soft})
    assert label.dtype == torch.float32
    _, label = _batch(sim, {"image": images, "label": np.array([1, 2])})
    assert label.dtype == torch.int64
