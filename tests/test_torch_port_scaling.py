"""``ivit_tpu_torch/scripts/scaling_bench.py`` (the port of
``scripts/scaling_bench.py``) on the CPU over gloo.

* ``measure`` on a 64 px depth-2 synthetic DeiT-S-width spec at widths 1
  and 2 (spawned worlds of one and two CPU ranks), weak and strong, with
  the server: every rank's gathered logits bitwise the single-device
  ``Engine(spec, device="cpu")``'s and JAX's ``engine_forward(pallas=False)``
  on the same spec and images; the served answers bitwise too; JAX's
  per-width keys, ``throughput_gain_vs_1dev`` (CPU ranks share the
  silicon), one ``all_gather`` a forward at width 2 and none at width 1.
* ``main`` with the registry's names built as a 64 px model: the artifact
  has JAX's keys with ``card`` in place of ``backend``, and the shared
  note; ``--distributed`` in a world of one joined from the environment.
* The refusals: more ranks than cards unless ``--devices`` names them,
  ``--serving`` with ``--distributed``, a width past the devices given.
"""

import os
import socket
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_workers as W  # noqa: E402
from test_torch_port_engine import _to_jax  # noqa: E402

from ivit_tpu.engine.vit_int import engine_forward as jax_engine_forward  # noqa: E402
from ivit_tpu_torch.engine import Engine  # noqa: E402
from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec  # noqa: E402
from ivit_tpu_torch.scripts import scaling_bench as S  # noqa: E402

JAX_KEYS = {"mode", "model", "family", "note", "results"}
WIDTH_KEYS = {"devices", "batch", "images_per_sec", "scaling_efficiency"}
SERVING_KEYS = {"serving_images_per_sec", "serving_fraction_of_raw"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec():
    return synthetic_spec(deit_small_config(depth=2, img_size=64), seed=0)


@pytest.fixture(scope="module")
def references(spec):
    """The single-device engine's and JAX's logits on the widest batch the
    tests draw (a shorter draw of a seed is its prefix)."""
    x = S.images(4, 64, S.BATCH_SEED)
    port = Engine(spec, device="cpu")(x).numpy()
    jax_logits = np.asarray(jax_engine_forward(_to_jax(spec), jnp.asarray(x),
                                               pallas=False))
    np.testing.assert_array_equal(port, jax_logits)
    return port


@pytest.mark.parametrize("mode", ["weak", "strong"])
def test_measure_widths_match_single_device_and_jax(spec, references, mode):
    results, runs = S.measure(spec, [1, 2], devices=["cpu", "cpu"], per_device_batch=2,
                              iters=2, mode=mode, serving=True, timeout=120)
    assert [r["devices"] for r in results] == [1, 2]
    assert [r["batch"] for r in results] == ([2, 4] if mode == "weak" else [4, 4])
    eng = Engine(spec, device="cpu")
    for rec, run in zip(results, runs):
        w = rec["devices"]
        assert WIDTH_KEYS | SERVING_KEYS <= set(rec)
        assert ("throughput_gain_vs_1dev" in rec) == (mode == "weak")
        assert rec["images_per_sec"] > 0 and run["backend"] == "gloo"
        assert len(run["ranks"]) == w
        for r in run["ranks"]:
            np.testing.assert_array_equal(r["logits"], references[:rec["batch"]])
            # the plain versions on the CPU: no kernel launched
            assert not any(r["launches"].values())
            gathers = r["collectives"].get("all_gather", {}).get("count", 0)
            assert gathers == (w > 1)
        want = eng(run["served_images"]).numpy()
        np.testing.assert_array_equal(run["served"], np.concatenate([want, want]))
    assert results[0]["scaling_efficiency"] == 1.0


@pytest.fixture()
def small_models(monkeypatch):
    import ivit_tpu_torch.models as tmodels
    monkeypatch.setattr(tmodels, "str2model", W.small_str2model)


def test_main_writes_jax_keys(small_models, tmp_path):
    out = tmp_path / "scaling.json"
    art = S.main(["--device", "cpu", "--widths", "1", "--per-device-batch", "2",
                  "--iters", "1", "--family", "ivit", "--out", str(out)])
    assert set(art) == JAX_KEYS | {"card"} and art["card"] == "cpu"
    assert "judge the curve by throughput_gain_vs_1dev" in art["note"]
    rec, = art["results"]
    assert WIDTH_KEYS | {"throughput_gain_vs_1dev"} == set(rec)
    import json
    assert json.loads(out.read_text()) == art


def test_distributed_world_of_one(small_models, monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    art = S.main(["--distributed", "--device", "cpu", "--per-device-batch", "2",
                  "--iters", "1", "--no-kernels"])
    assert art["card"] == "cpu" and art["results"][0]["devices"] == 1
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--serving"):
        S.main(["--distributed", "--serving", "--device", "cpu"])


def test_refusals(spec, monkeypatch):
    with pytest.raises(ValueError, match="width 2 needs 2 devices"):
        S.measure(spec, [1, 2], devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            S.main(["--widths", "1"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="this host has 1 card"):
        S._devices(S.parse_args(["--widths", "1", "2"]))
    assert S._devices(S.parse_args(["--widths", "2", "--devices", "cuda:0",
                                    "cuda:0"])) == ["cuda:0", "cuda:0"]
    assert S.shares_silicon(["cuda:0", "cuda:0"]) and not S.shares_silicon(["cuda:0"])
    assert S.shares_silicon(["cpu"])
