"""The data pipeline (counterpart of ``ivit_tpu/train/data.py``).

ImageNet-style ImageFolder, CIFAR-100 (pickle batches) and a seeded
synthetic dataset; the train transform (random-resized-crop, hflip,
RandAugment or colour jitter, random erasing: timm's
``transforms_imagenet_train`` order), the eval resize (1/0.875) and centre
crop, Mixup/CutMix with label smoothing (timm Mixup parity for the used
options), the repeated-augmentation order (ref ``utils/samplers.py``
RASampler) and the threaded batch loader.  Images are HWC uint8 from a
dataset and NHWC float32 in a batch, as in JAX.

The JAX package resizes and decodes through Pillow; the port does both in
numpy (``train/image_ops.py``, bit for bit as Pillow), so it needs no image
library: PNG and BMP files are always decoded by the port's own decoders,
JPEG and WebP only where Pillow is installed.  Every random draw is JAX's,
in JAX's order, so the same seeds give the same batches bit for bit.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from . import image_ops

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _native_preproc():
    """The C++ eval-preprocess batch fn (``utils/native.py``: compiled from
    ``native/preproc.cpp`` at first use; a failed build raises)."""
    from ..utils import native
    native.load_library()
    return native.preprocess_batch


class Dataset:
    """Minimal dataset protocol: len + get(i) -> (HWC uint8 image, label)."""

    num_classes: int = 1000

    def __len__(self):  # pragma: no cover - interface
        raise NotImplementedError

    def get(self, index: int):  # pragma: no cover - interface
        raise NotImplementedError


class SyntheticDataset(Dataset):
    """Deterministic random images -- tests and throughput benchmarks."""

    def __init__(self, n: int = 512, img_size: int = 224,
                 num_classes: int = 1000, seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.n

    def get(self, index):
        rng = np.random.default_rng(self.seed * 1000003 + index)
        img = rng.integers(0, 256, (self.img_size, self.img_size, 3),
                           dtype=np.uint8)
        return img, int(rng.integers(0, self.num_classes))


def _format_of(head: bytes) -> str:
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return "an unrecognised format"


def read_rgb(path: str) -> np.ndarray:
    """The file at ``path`` as RGB uint8 HWC, as
    ``np.asarray(Image.open(path).convert("RGB"))``: PNG and BMP through
    ``image_ops``' decoders, anything else through Pillow where it is
    installed; without Pillow that raises, naming the format and the file."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(image_ops.PNG_SIGNATURE):
        return image_ops.decode_png(data, path)
    if data.startswith(b"BM"):
        return image_ops.decode_bmp(data, path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: {_format_of(data[:12])} needs Pillow, which is not "
                           "installed; the port decodes PNG and BMP itself") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ImageFolderDataset(Dataset):
    """ImageNet-layout directory: root/<class>/<image>.{jpg,png,...}."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str):
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.num_classes = len(classes)
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(self.EXTS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def get(self, index):
        path, label = self.samples[index]
        return read_rgb(path), label


class CIFAR100Dataset(Dataset):
    """CIFAR-100 python pickle files (ref data_utils.py CIFAR branch)."""

    def __init__(self, root: str, train: bool = True):
        name = "train" if train else "test"
        with open(os.path.join(root, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self.images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = d[b"fine_labels"]
        self.num_classes = 100

    def __len__(self):
        return len(self.labels)

    def get(self, index):
        return self.images[index], int(self.labels[index])


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def _resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    return image_ops.resize_bicubic(img, size)


def train_transform(img: np.ndarray, rng: np.random.Generator,
                    img_size: int = 224, hflip: float = 0.5,
                    color_jitter: float = 0.4,
                    erase_prob: float = 0.25,
                    rand_augment=None) -> np.ndarray:
    """Random-resized-crop + flip + RandAugment/jitter + random-erase.

    Mirrors timm ``transforms_imagenet_train`` op order (the reference's
    ``create_transform`` recipe, ``utils/data_utils.py:42-55``): RRC and
    flip on uint8, then RandAugment (uint8 ops) when configured -- which,
    like timm, disables color jitter -- then normalize + erase.
    Returns f32 HWC.
    """
    h, w = img.shape[:2]
    # random resized crop: scale [0.08, 1], ratio [3/4, 4/3]
    for _ in range(10):
        area = h * w * rng.uniform(0.08, 1.0)
        ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(area * ratio)))
        ch = int(round(np.sqrt(area / ratio)))
        if cw <= w and ch <= h:
            y0 = rng.integers(0, h - ch + 1)
            x0 = rng.integers(0, w - cw + 1)
            img = img[y0:y0 + ch, x0:x0 + cw]
            break
    img = _resize(img, (img_size, img_size))

    if rng.random() < hflip:
        img = img[:, ::-1]
    if rand_augment is not None:
        img = rand_augment(np.ascontiguousarray(img), rng)
        color_jitter = 0.0                    # timm: aa replaces jitter
    img = img.astype(np.float32) / 255.0
    if color_jitter > 0:
        # brightness/contrast/saturation jitter
        img = img * rng.uniform(1 - color_jitter, 1 + color_jitter)
        mean = img.mean()
        img = (img - mean) * rng.uniform(1 - color_jitter,
                                         1 + color_jitter) + mean
        gray = img.mean(axis=-1, keepdims=True)
        alpha = rng.uniform(1 - color_jitter, 1 + color_jitter)
        img = alpha * img + (1 - alpha) * gray
        img = np.clip(img, 0, 1)

    img = (img - IMAGENET_MEAN) / IMAGENET_STD

    if rng.random() < erase_prob:
        eh = rng.integers(img_size // 8, img_size // 3)
        ew = rng.integers(img_size // 8, img_size // 3)
        y0 = rng.integers(0, img_size - eh)
        x0 = rng.integers(0, img_size - ew)
        img[y0:y0 + eh, x0:x0 + ew] = rng.normal(
            size=(eh, ew, 3)).astype(np.float32)
    return np.ascontiguousarray(img, np.float32)


def eval_transform(img: np.ndarray, img_size: int = 224) -> np.ndarray:
    """Resize shorter side to size/0.875 then center-crop (ref data_utils)."""
    h, w = img.shape[:2]
    scale = int(img_size / 0.875)
    if h < w:
        nh, nw = scale, max(scale, int(round(w * scale / h)))
    else:
        nh, nw = max(scale, int(round(h * scale / w))), scale
    img = _resize(img, (nh, nw)).astype(np.float32) / 255.0
    y0 = (nh - img_size) // 2
    x0 = (nw - img_size) // 2
    img = img[y0:y0 + img_size, x0:x0 + img_size]
    return np.ascontiguousarray((img - IMAGENET_MEAN) / IMAGENET_STD,
                                np.float32)


class Mixup:
    """Mixup or CutMix of a batch, with label-smoothed soft targets
    (ref: timm Mixup via quant_train.py:330-345)."""

    def __init__(self, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 label_smoothing: float = 0.1, num_classes: int = 1000):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.prob = prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    def _one_hot(self, labels, lam, perm):
        off = self.label_smoothing / self.num_classes
        on = 1.0 - self.label_smoothing + off
        y = np.full((len(labels), self.num_classes), off, np.float32)
        y[np.arange(len(labels)), labels] = on
        return lam * y + (1 - lam) * y[perm]

    def __call__(self, images, labels, rng: np.random.Generator):
        if rng.random() > self.prob:
            return images, self._one_hot(labels, 1.0, np.arange(len(labels)))
        perm = rng.permutation(len(labels))
        use_cutmix = (self.cutmix_alpha > 0
                      and rng.random() < self.switch_prob)
        if use_cutmix:
            lam = float(rng.beta(self.cutmix_alpha, self.cutmix_alpha))
            h, w = images.shape[1:3]
            rh, rw = int(h * np.sqrt(1 - lam)), int(w * np.sqrt(1 - lam))
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            y0, y1 = np.clip(cy - rh // 2, 0, h), np.clip(cy + rh // 2, 0, h)
            x0, x1 = np.clip(cx - rw // 2, 0, w), np.clip(cx + rw // 2, 0, w)
            images = images.copy()
            images[:, y0:y1, x0:x1] = images[perm, y0:y1, x0:x1]
            lam = 1 - (y1 - y0) * (x1 - x0) / (h * w)
        else:
            lam = float(rng.beta(self.mixup_alpha, self.mixup_alpha)) \
                if self.mixup_alpha > 0 else 1.0
            images = lam * images + (1 - lam) * images[perm]
        return images.astype(np.float32), self._one_hot(labels, lam, perm)


def repeated_aug_indices(n: int, rng: np.random.Generator,
                         repeats: int = 3) -> np.ndarray:
    """RASampler-equivalent (ref utils/samplers.py:8-65, single host):
    shuffle, repeat each index `repeats` times, truncate to n."""
    idx = rng.permutation(n)
    rep = np.repeat(idx, repeats)
    return rep[:n]


def data_loader(dataset: Dataset, batch_size: int, *, train: bool,
                img_size: int = 224, seed: int = 0,
                repeated_aug: bool = False, drop_last: Optional[bool] = None,
                num_threads: int = 8, rand_augment=None) -> Iterator[dict]:
    """Threaded batch iterator yielding {'image': f32 NHWC, 'label': i32}.

    A thread pool feeding a bounded queue (numpy releases the GIL in its
    array loops); batch ``bi`` of a train pass draws image ``i``'s
    augmentation from ``default_rng(seed * 7919 + i * 31 + bi)``, so the
    batches do not depend on the thread count.  An eval image already at
    ``img_size`` is only normalised; the others go through the native
    resize + centre crop (``utils/native.py``).  A worker's exception is
    raised to the consumer (JAX's loader waits forever on it).
    """
    rng = np.random.default_rng(seed)
    n = len(dataset)
    if train:
        order = (repeated_aug_indices(n, rng) if repeated_aug
                 else rng.permutation(n))
    else:
        order = np.arange(n)
    drop_last = train if drop_last is None else drop_last
    nb = n // batch_size if drop_last else (n + batch_size - 1) // batch_size

    def make_batch(bi):
        idxs = order[bi * batch_size:(bi + 1) * batch_size]
        imgs = np.empty((len(idxs), img_size, img_size, 3), np.float32)
        labels = np.empty((len(idxs),), np.int32)
        raw, raw_slots = [], []
        for j, i in enumerate(idxs):
            img, lab = dataset.get(int(i))
            if train:
                r = np.random.default_rng(seed * 7919 + int(i) * 31 + bi)
                imgs[j] = train_transform(img, r, img_size,
                                          rand_augment=rand_augment)
            else:
                if img.shape[0] == img_size and img.shape[1] == img_size:
                    imgs[j] = ((img.astype(np.float32) / 255.0
                                - IMAGENET_MEAN) / IMAGENET_STD)
                elif _native_preproc() is not None:
                    raw.append(np.ascontiguousarray(img, np.uint8))
                    raw_slots.append(j)
                else:
                    imgs[j] = eval_transform(img, img_size)
            labels[j] = lab
        if raw:
            # native C++ multi-threaded resize+crop+normalize fast path
            batch = _native_preproc()(raw, out_size=img_size)
            for k, j in enumerate(raw_slots):
                imgs[j] = batch[k]
        return {"image": imgs, "label": labels}

    if num_threads <= 1:
        for bi in range(nb):
            yield make_batch(bi)
        return

    q: queue_mod.Queue = queue_mod.Queue(maxsize=num_threads)
    stop = threading.Event()

    def worker(tid):
        try:
            for bi in range(tid, nb, num_threads):
                if stop.is_set():
                    return
                q.put((bi, make_batch(bi)))
        except Exception as e:             # the consumer raises it
            q.put((None, e))

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(min(num_threads, nb))]
    for t in threads:
        t.start()
    try:
        pending = {}
        for want in range(nb):
            while want not in pending:
                bi, batch = q.get()
                if bi is None:
                    raise batch
                pending[bi] = batch
            yield pending.pop(want)
    finally:
        stop.set()
        for _ in range(nb):
            if q.empty():
                break
            q.get_nowait()
