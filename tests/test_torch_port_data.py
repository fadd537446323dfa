"""The port's data pipeline (``ivit_tpu_torch/train/data.py``,
``randaug.py``, ``utils/native.py``) bit for bit against the JAX
package's Pillow-backed code.

* ``train_transform`` (aa none, ``rand-m9-mstd0.5``,
  ``rand-m9-mstd0.5-inc1``) and ``eval_transform`` on seeded images and
  rngs: the output bitwise and the rng's state equal after each call;
* every RandAugment op against JAX's, both level flavours, levels 0 to 10,
  the rng's state equal after each (the draws stay in JAX's order);
* ``data_loader`` over the same ``tmp_path`` ImageFolder read by each
  package's dataset (the port's own PNG/BMP decoders, Pillow's in JAX):
  train batches with 1 and 2 threads and ``repeated_aug``, eval batches
  with both packages' native path off; the samples and labels;
* ``CIFAR100Dataset`` on a pickle written in ``tmp_path``;
* the port's ctypes binding of ``native/preproc.cpp`` against JAX's, both
  loading the library the port builds;
* the first train batch of ``chip_smoke.py``'s ``trainer`` phase: its
  sha256 through JAX's pipeline is the digest the card run asserts.
Tolerance 0 everywhere.
"""

import hashlib
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ivit_tpu.train import data as jdata
from ivit_tpu.train import randaug as jaug
from ivit_tpu.utils import native as jnative
from ivit_tpu_torch.train import data as tdata
from ivit_tpu_torch.train import randaug as taug
from ivit_tpu_torch.utils import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA = [None, "rand-m9-mstd0.5", "rand-m9-mstd0.5-inc1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every port CPU test file (Tier-1 runs six
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / rng.uniform(3, 12))[..., None] * 90
            + np.cos(yy / rng.uniform(3, 12))[..., None] * 70 + 128
            + rng.normal(0, 12, (h, w, 3)))
    return np.clip(base, 0, 255).astype(np.uint8)


def _same_state(a, b):
    return a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("aa", AA)
def test_train_transform_matches_jax(aa):
    rng = np.random.default_rng(20)
    jra, tra = jaug.parse_rand_augment(aa), taug.parse_rand_augment(aa)
    for i in range(12):
        h, w = (int(v) for v in rng.integers(8, 300, 2))
        img = _image(rng, h, w)
        size = (64, 224)[i % 2]
        jr, tr = np.random.default_rng(i), np.random.default_rng(i)
        want = jdata.train_transform(img, jr, size, rand_augment=jra)
        got = tdata.train_transform(img, tr, size, rand_augment=tra)
        np.testing.assert_array_equal(got, want, err_msg=f"{img.shape} seed {i}")
        assert _same_state(jr, tr)


def test_eval_transform_matches_jax():
    rng = np.random.default_rng(21)
    for i in range(12):
        h, w = (int(v) for v in rng.integers(8, 400, 2))
        img = _image(rng, h, w)
        size = (64, 224)[i % 2]
        np.testing.assert_array_equal(tdata.eval_transform(img, size),
                                      jdata.eval_transform(img, size),
                                      err_msg=str(img.shape))


@pytest.mark.parametrize("name", [n for n, _ in taug.RAND_TRANSFORMS])
def test_randaugment_op_matches_jax(name):
    """Both flavours, levels 0, 2.5, 5, 9, 10 and random ones, each
    application from its own seed: the image and the rng state after."""
    jop = dict(jaug.RAND_TRANSFORMS)[name]
    top = dict(taug.RAND_TRANSFORMS)[name]
    rng = np.random.default_rng(22)
    for i in range(12):
        h, w = (int(v) for v in rng.integers(3, 120, 2))
        img = _image(rng, h, w)
        level = [0.0, 2.5, 5.0, 9.0, 10.0, float(rng.uniform(0, 10))][i % 6]
        for inc in (False, True):
            jr, tr = np.random.default_rng(100 + i), np.random.default_rng(100 + i)
            want = np.asarray(jop(Image.fromarray(img), level, jaug.IMAGENET_FILL, jr,
                                  inc=inc))
            got = top(img, level, taug.IMAGENET_FILL, tr, inc=inc)
            np.testing.assert_array_equal(got, want, err_msg=f"{img.shape} {level} {inc}")
            assert _same_state(jr, tr)


def test_randaugment_policy_matches_jax():
    """The whole policy, both flavours and an ``n3-p0.8`` variant, and the
    parser's refusals."""
    rng = np.random.default_rng(23)
    for cfg in ("rand-m9-mstd0.5", "rand-m9-mstd0.5-inc1", "rand-m7-n3-p0.8-mstd1.0"):
        jra, tra = jaug.parse_rand_augment(cfg), taug.parse_rand_augment(cfg)
        assert vars(jra) == vars(tra)
        for i in range(16):
            img = _image(rng, 64, 64)
            jr, tr = np.random.default_rng(i), np.random.default_rng(i)
            np.testing.assert_array_equal(tra(img, tr), jra(img, jr))
            assert _same_state(jr, tr)
    assert taug.parse_rand_augment("none") is None
    for bad in ("augmix-m9", "rand-x3"):
        with pytest.raises(ValueError):
            taug.parse_rand_augment(bad)


def _write_folder(root, classes=3, per_class=5, seed=24):
    """An ImageFolder of PNG (RGB, gray, palette) and BMP files, 20-120 px."""
    rng = np.random.default_rng(seed)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"class_{c}"))
        for k in range(per_class):
            h, w = (int(v) for v in rng.integers(20, 120, 2))
            im = Image.fromarray(_image(rng, h, w))
            ext = "bmp" if k == 3 else "png"
            if k == 1:
                im = im.convert("L")
            elif k == 2:
                im = im.convert("P", palette=Image.ADAPTIVE, colors=16)
            im.save(os.path.join(root, f"class_{c}", f"img_{k}.{ext}"))
    open(os.path.join(root, "class_0", "notes.txt"), "w").close()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("folder"))
    _write_folder(root)
    return root


def test_image_folder_matches_jax(folder):
    jds, tds = jdata.ImageFolderDataset(folder), tdata.ImageFolderDataset(folder)
    assert tds.EXTS == jds.EXTS
    assert tds.samples == jds.samples and tds.class_to_idx == jds.class_to_idx
    assert tds.num_classes == jds.num_classes == 3 and len(tds) == 15
    for i in range(len(tds)):
        (a, la), (b, lb) = tds.get(i), jds.get(i)
        np.testing.assert_array_equal(a, b)
        assert la == lb


def test_port_decodes_png_and_bmp_without_pillow(folder, monkeypatch):
    """PNG and BMP never reach Pillow; a JPEG without Pillow raises,
    naming the format and the file."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    tds = tdata.ImageFolderDataset(folder)
    for i in range(len(tds)):
        tds.get(i)
    path = os.path.join(folder, "class_1", "photo.jpg")
    with open(path, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(16))
    try:
        ds = tdata.ImageFolderDataset(folder)
        i = [p for p, _ in ds.samples].index(path)
        with pytest.raises(RuntimeError, match=r"photo\.jpg: JPEG needs Pillow"):
            ds.get(i)
    finally:
        os.remove(path)


def _batches(mod, ds, **kw):
    return list(mod.data_loader(ds, 4, img_size=64, **kw))


@pytest.mark.parametrize("threads,repeated", [(1, False), (2, True)])
def test_train_loader_matches_jax(folder, threads, repeated):
    jds, tds = jdata.ImageFolderDataset(folder), tdata.ImageFolderDataset(folder)
    aa = "rand-m9-mstd0.5-inc1"
    kw = dict(train=True, seed=3, repeated_aug=repeated, num_threads=threads)
    want = _batches(jdata, jds, rand_augment=jaug.parse_rand_augment(aa), **kw)
    got = _batches(tdata, tds, rand_augment=taug.parse_rand_augment(aa), **kw)
    assert len(got) == len(want) == 3                   # drop_last
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_eval_loader_matches_jax(folder, monkeypatch):
    """The Pillow-equal path of both packages (native preprocess off), and
    the partial last batch; one image already at the eval size is only
    normalised."""
    monkeypatch.setattr(jdata, "_native_preproc", lambda: None)
    monkeypatch.setattr(tdata, "_native_preproc", lambda: None)
    jds, tds = jdata.SyntheticDataset(n=2, img_size=64), tdata.SyntheticDataset(n=2, img_size=64)
    for ds_j, ds_t in ((jdata.ImageFolderDataset(folder), tdata.ImageFolderDataset(folder)),
                       (jds, tds)):
        want = _batches(jdata, ds_j, train=False, num_threads=2)
        got = _batches(tdata, ds_t, train=False, num_threads=2)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])


def test_loader_raises_a_worker_error(tmp_path):
    """A file that fails to decode raises in the consumer (JAX's loader
    waits forever on a worker that died)."""
    os.makedirs(tmp_path / "a")
    (tmp_path / "a" / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(8))
    ds = tdata.ImageFolderDataset(str(tmp_path))
    with pytest.raises(ValueError, match="bad.png"):
        list(tdata.data_loader(ds, 1, train=True, img_size=32, num_threads=2))


def test_cifar100_matches_jax(tmp_path):
    rng = np.random.default_rng(25)
    for name, n in (("train", 6), ("test", 4)):
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             b"fine_labels": [int(v) for v in rng.integers(0, 100, n)]}
        with open(tmp_path / name, "wb") as f:
            pickle.dump(d, f)
    for train in (True, False):
        jds = jdata.CIFAR100Dataset(str(tmp_path), train=train)
        tds = tdata.CIFAR100Dataset(str(tmp_path), train=train)
        assert len(tds) == len(jds) and tds.num_classes == 100
        for i in range(len(tds)):
            (a, la), (b, lb) = tds.get(i), jds.get(i)
            np.testing.assert_array_equal(a, b)
            assert la == lb


def test_native_binding_matches_jax(monkeypatch):
    """Both bindings load the library the port builds from
    ``native/preproc.cpp`` (JAX's looks at ``native/libivit_preproc.so``
    first, so its lookup is pointed at the port's build; this changes only
    this process)."""
    path = tnative.build()
    assert path.startswith(os.path.join(ROOT, "build", "ivit_tpu_torch"))
    monkeypatch.setenv("IVIT_PREPROC_LIB", path)
    monkeypatch.setattr(jnative, "_find_lib", lambda: path)
    monkeypatch.setattr(jnative, "_TRIED", False)
    monkeypatch.setattr(jnative, "_LIB", None)
    assert tnative.available() and jnative.available()
    rng = np.random.default_rng(26)
    imgs = [_image(rng, int(h), int(w)) for h, w in rng.integers(16, 200, (5, 2))]
    got = tnative.preprocess_batch(imgs, out_size=64, num_threads=2)
    want = jnative.preprocess_batch(imgs, out_size=64, num_threads=2)
    assert got.shape == (5, 64, 64, 3)
    np.testing.assert_array_equal(got, want)
    assert tdata._native_preproc() is tnative.preprocess_batch
    with pytest.raises(ValueError, match="HWC uint8"):
        tnative.preprocess_batch([imgs[0][..., 0]])


def test_trainer_smoke_first_batch_digest(tmp_path):
    """``chip_smoke.py``'s trainer folder: the first train batch of epoch 0
    through JAX's pipeline (Pillow) and the port's, 1 and 2 threads, has
    the digest the card run asserts (``TRAINER_FIRST_BATCH_SHA256``)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    chip_smoke.write_trainer_folder(str(tmp_path))
    root = os.path.join(str(tmp_path), "train")
    kw = dict(train=True, img_size=224, seed=chip_smoke.QAT_SEED)
    aa = chip_smoke.TRAINER_AA
    want = next(jdata.data_loader(jdata.ImageFolderDataset(root), chip_smoke.TRAINER_BATCH,
                                  rand_augment=jaug.parse_rand_augment(aa),
                                  num_threads=1, **kw))
    for threads in (1, 2):
        got = next(tdata.data_loader(tdata.ImageFolderDataset(root),
                                     chip_smoke.TRAINER_BATCH,
                                     rand_augment=taug.parse_rand_augment(aa),
                                     num_threads=threads, **kw))
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["label"], want["label"])
    digest = hashlib.sha256(want["image"].tobytes() + want["label"].tobytes()).hexdigest()
    assert chip_smoke.batch_digest(want) == digest
    assert digest == chip_smoke.TRAINER_FIRST_BATCH_SHA256
