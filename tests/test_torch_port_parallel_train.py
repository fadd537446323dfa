"""Training under the port's mesh, its CLI flags and the multi-process demo,
on the CPU over gloo.

* One spawned world of 4 ranks (``tests/_torch_parallel_workers.py``,
  ``file://`` rendezvous under ``tmp_path``, one torch thread a rank): one
  train step at dp x tp 4x1 and 2x2 (drop-path 0.1, so the global-shape
  masks are drawn; the gradient norm logged; clipped by it; SGD as
  ``tests/test_parallel.py`` steps) against the port's single-device step
  on the global batch: ``quant_stats`` bitwise, the loss and the gradient
  norm within rtol 1e-5, the params within rtol 2e-4 / atol 2e-6 --
  ``tests/test_parallel.py:51-58``'s own bounds, since the gradient is
  summed in another order there too; a ``Trainer`` at ``mesh_dp=2,
  mesh_tp=2`` (``tests/test_trainer.py:78``'s check, on a 4-head 64 px ViT
  through a monkeypatched registry) fits one epoch, rank 0's checkpoint
  has the single-device run's leaf names and shapes, and a resume from it
  runs the second epoch.
* The CLI: ``quant_train --device cpu --mesh-dp 2`` spawns its two ranks;
  ``--distributed`` joins a world of 2 processes from torchrun's
  environment variables; ``--mesh-dp 2 --mesh-tp 2`` with ``--device cuda``
  on a host with fewer cards raises naming the count.
* ``multihost_demo --small --device cpu``: two workers, ``all_bitexact``
  and ``serving_logits_ok`` (``tests/test_multihost.py``'s checks); with
  ``--device cuda`` on a host with fewer cards than processes it raises
  naming the count.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_workers as W  # noqa: E402

from ivit_tpu_torch.models.convert import differing_leaves  # noqa: E402
from ivit_tpu_torch.parallel import launch  # noqa: E402
from ivit_tpu_torch.scripts import multihost_demo, quant_train  # noqa: E402
from ivit_tpu_torch.train import checkpoint as ckpt_io  # noqa: E402
from ivit_tpu_torch.train import optim  # noqa: E402
from ivit_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from ivit_tpu_torch.train.serialization import msgpack_restore  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI runs: DeiT-T (the CLI's default) at 32 px, 8 synthetic images
CLI_ARGS = ["--dataset", "synthetic", "--synthetic-samples", "8", "--batch-size", "4",
            "--epochs", "1", "--img-size", "32", "--calibration-batches", "1",
            "--aa", "none", "--mixup", "0", "--cutmix", "0", "--log-interval", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mesh_runs")
    rdv = tmp_path_factory.mktemp("rendezvous") / "file"
    res = launch.spawn(W.train_rank, 4, devices=["cpu"] * 4, init_file=str(rdv),
                       args=(str(out_dir),), timeout=300)
    return res, str(out_dir)


@pytest.fixture(scope="module")
def single_step():
    return W.train_step(W.train_sim(), W.train_batch())


@pytest.mark.parametrize("dp,tp", W.TRAIN_MESHES)
def test_mesh_train_step_matches_single_device(world, single_step, dp, tp):
    want_m, want_p, want_qs = single_step
    for r in range(4):
        metrics, params, qs = world[0][r][(dp, tp)]
        assert differing_leaves(qs, want_qs) == []
        np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"], want_m["grad_norm"], rtol=1e-5)
        got, want = list(optim.tree_paths(params)), list(optim.tree_paths(want_p))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6, err_msg=str(path))
        # every rank ends with the same parameters
        assert differing_leaves(params, world[0][0][(dp, tp)][1]) == []


def _shapes(tree):
    return {path: np.asarray(leaf).shape for path, leaf in optim.tree_paths(tree)}


def test_mesh_trainer_fits_checkpoints_and_resumes(world, monkeypatch):
    res, out_dir = world
    fit = res[0]["fit"]
    assert fit["step"] == 2 and fit["qkv_local"] == (64, 96)   # 3 x 2 of 4 heads
    for r in range(4):
        assert res[r]["fit"]["step"] == 2
    assert res[0]["resume"] == {"start_epoch": 1, "step_before": 2, "step_after": 4}
    # rank 0 logs: one log, JAX's epoch records
    assert os.listdir(out_dir).count("log_mesh.jsonl") == 1
    with open(os.path.join(out_dir, "log_mesh.jsonl")) as f:
        epochs = [r["epoch"] for r in map(json.loads, f) if r["phase"] == "epoch"]
    assert epochs == [0, 1]
    # the checkpoint has the single-device run's leaf names and shapes
    monkeypatch.setattr(trainer_mod, "str2model", W.small_str2model)
    single = trainer_mod.Trainer(W.trainer_cfg(os.path.join(out_dir, "single")),
                                 *W.trainer_data(), device="cpu")
    want = ckpt_io.state_dict(single.state, single.ema_params)
    with open(os.path.join(out_dir, "checkpoint_mesh", "state.msgpack"), "rb") as f:
        got = msgpack_restore(f.read())
    assert sorted(got) == sorted(want)
    for k in want:
        assert _shapes(got[k]) == _shapes(want[k]), k


def test_cli_mesh_dp_on_cpu(tmp_path):
    best = quant_train.main([*CLI_ARGS, "--device", "cpu", "--mesh-dp", "2",
                             "--output-dir", str(tmp_path), "--run-id", "dp"])
    assert len(best) == 2 and best[0] == best[1]
    assert os.path.exists(tmp_path / "checkpoint_dp" / "state.msgpack")
    with open(tmp_path / "log_dp.jsonl") as f:
        losses = [r["loss"] for r in map(json.loads, f) if r["phase"] == "train"]
    assert len(losses) == 2 and np.isfinite(losses).all()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_distributed_env_rendezvous(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ivit_tpu_torch.scripts.quant_train", *CLI_ARGS,
             "--distributed", "--device", "cpu", "--output-dir", str(tmp_path),
             "--run-id", "env"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-2000:] for o in outs)
    assert os.path.exists(tmp_path / "checkpoint_env" / "state.msgpack")
    with open(tmp_path / "log_env.jsonl") as f:
        assert sum(r["phase"] == "train" for r in map(json.loads, f)) == 2


def test_cli_mesh_needs_a_card_a_rank(tmp_path):
    if torch.cuda.device_count() >= 4:
        pytest.skip("this host has the cards")
    with pytest.raises(RuntimeError, match="--mesh-dp 2 --mesh-tp 2 spawns 4 processes, "
                                           "one a card"):
        quant_train.main([*CLI_ARGS, "--mesh-dp", "2", "--mesh-tp", "2",
                          "--output-dir", str(tmp_path), "--device", "cuda"])


def test_multihost_demo_small(tmp_path):
    out = tmp_path / "MULTIHOST.json"
    multihost_demo.main(["--small", "--device", "cpu", "--run-dir", str(tmp_path / "run"),
                         "--out", str(out), "--timeout", "300"])
    merged = json.loads(out.read_text())
    assert merged["all_bitexact"]
    assert len(merged["workers"]) == 2
    for w in merged["workers"]:
        assert w["global_devices"] == 2 and w["local_devices"] == 1
        assert w["serving_logits_ok"]


def test_multihost_demo_needs_a_card_a_process(monkeypatch):
    """The demo, as the CLI, never puts two ranks on one card quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--num-processes 2 runs one process a card, "
                                           r"and this host has 1 card\(s\)"):
        multihost_demo.main(["--small", "--device", "cuda"])
    assert multihost_demo._devices("cpu", 2) == ["cpu", "cpu"]
