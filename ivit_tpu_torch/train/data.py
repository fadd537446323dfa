"""The numpy-only part of the data pipeline (a copy of the pieces of
``ivit_tpu/train/data.py`` that need no image library): the dataset
protocol, a seeded synthetic dataset, Mixup/CutMix with label smoothing
(timm Mixup parity for the used options) and the repeated-augmentation
order (ref ``utils/samplers.py`` RASampler).  Images are HWC uint8 from a
dataset and NHWC float32 in a batch, as in JAX.
"""

from __future__ import annotations

import numpy as np


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
