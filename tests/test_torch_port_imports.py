"""The PyTorch port stands alone: no JAX, nothing of ``ivit_tpu``, no
``msgpack`` (the card's environment is not known to have it: the port's
checkpoints use its own codec), no ``pandas`` (the card has none: the IO
statistics are written and read with ``csv``), and its entry points run on
CUDA unless asked for the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ivit_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ivit_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ivit_tpu_torch.__path__,
                                              "ivit_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "ivit_tpu", "msgpack", "pandas")]
assert not bad, bad
print(" ".join(mods))
"""


def test_port_imports_no_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 12                        # every module was imported
    assert {f"ivit_tpu_torch.scripts.{m}" for m in (
        "inference", "engine_inference", "serving_bench", "analyze_io_stats",
        "quant_train")} <= mods


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_no_jax_nor_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|ivit_tpu|msgpack|pandas)(\.|\s|$)",
                     re.M)
    for path in _sources():
        with open(path) as f:
            hits = pat.findall(f.read())
        assert not hits, (path, hits)


def _tiny_spec():
    from ivit_tpu_torch.engine.freeze import EngineConfig
    from ivit_tpu_torch.engine.synthetic import synthetic_spec
    from ivit_tpu_torch.models import BitWidths
    cfg = EngineConfig(img_size=32, patch_size=16, embed_dim=64, depth=1,
                       num_heads=2, mlp_ratio=4.0, num_classes=10,
                       bitwidths=BitWidths(), gelu_type="ibert",
                       softmax_type="ibert", layernorm_type="ibert")
    return synthetic_spec(cfg, seed=0)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs")
    from ivit_tpu_torch.engine import (Engine, engine_forward, load_engine,
                                       save_engine)
    spec = _tiny_spec()
    save_engine(spec, str(tmp_path / "eng"))
    x = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_forward(spec, x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_engine(str(tmp_path / "eng"))
    from ivit_tpu_torch.engine import swin_engine_forward
    from ivit_tpu_torch.engine.synthetic import swin_tiny_config, synthetic_swin_spec
    swin = synthetic_swin_spec(swin_tiny_config(depths=(1,), img_size=28,
                                                embed_dim=32, stage_heads=(2,),
                                                num_classes=10), seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(swin)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        swin_engine_forward(swin, np.zeros((1, 28, 28, 3), np.float32))


def test_entry_points_run_on_cpu_when_asked(tmp_path):
    from ivit_tpu_torch.engine import (Engine, engine_forward, load_engine,
                                       save_engine)
    spec = _tiny_spec()
    save_engine(spec, str(tmp_path / "eng"))
    loaded = load_engine(str(tmp_path / "eng"), device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = Engine(loaded, device="cpu")(x)
    assert y.shape == (2, 10) and y.device.type == "cpu"
    assert torch.equal(y, engine_forward(spec, x, kernels=False, device="cpu"))


_IMPORT_TRAINING = """
import sys
import ivit_tpu_torch.train.image_ops, ivit_tpu_torch.train.data
import ivit_tpu_torch.train.randaug, ivit_tpu_torch.train.trainer
import ivit_tpu_torch.utils.native, ivit_tpu_torch.utils.metrics
import ivit_tpu_torch.scripts.quant_train
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "ivit_tpu", "PIL")]
assert not bad, bad
"""


def test_training_modules_import_neither_jax_nor_pillow():
    """The image pipeline, the loop and the CLI import no JAX and no Pillow
    (the card's listed installation has no Pillow): PNG and BMP are
    decoded by the port itself."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_TRAINING], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_training_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs")
    from ivit_tpu_torch.scripts import quant_train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quant_train.main(["--dataset", "synthetic", "--synthetic-samples", "4",
                          "--batch-size", "4", "--img-size", "32", "--epochs", "1"])
