"""RandAugment -- the reference's training augmentation policy
(counterpart of ``ivit_tpu/train/randaug.py``), on uint8 HWC arrays.

The reference builds its train transform through timm's
``create_transform(auto_augment='rand-m9-mstd0.5', ...)``
(the reference's ``utils/data_utils.py:42-55``); JAX reimplements that
policy (timm ``auto_augment.py`` semantics) on numpy + Pillow, and this
module runs the same ops through ``train/image_ops.py`` (Pillow's
arithmetic, bit for bit) with every random draw in JAX's order:

* N = 2 ops drawn uniformly (with replacement) from the 15-op
  ``RAND_TRANSFORMS`` pool, each applied with probability 0.5;
* magnitude M = 9 on the 0..10 scale, perturbed per-application by
  ``gauss(M, mstd)`` with mstd = 0.5, clamped to [0, 10];
* timm's level maps, both flavors: plain -- enhance ops scale as
  ``(M/10)*1.8 + 0.1``, posterize keeps ``int((M/10)*4)`` bits, solarize
  thresholds at ``int((M/10)*256)``; "increasing" (the reference default,
  ``rand-m9-mstd0.5-inc1``) -- enhance = ``1 +- (M/10)*0.9``, posterize
  keeps ``4 - int((M/10)*4)`` bits, solarize thresholds at
  ``256 - int((M/10)*256)``; geometric ops are ``(M/10)*limit`` with random
  sign and solarize-add adds ``int((M/10)*110)`` below 128 in both;
* geometric fill color = the dataset mean scaled to uint8
  (``(124, 116, 104)`` for ImageNet), interpolation drawn from
  {bilinear, bicubic} per op.

The draws of one application: the op (``integers``), its probability
(``random``), the level (``normal``), the sign (``random``, where the level
map negates), the interpolation (``integers``, geometric ops).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from . import image_ops as ops

_LEVEL_DENOM = 10.0

# timm aa_params: img_mean = tuple(min(255, round(255*x)) for x in mean)
IMAGENET_FILL = (124, 116, 104)


def _randomly_negate(v: float, rng: np.random.Generator) -> float:
    return -v if rng.random() > 0.5 else v


# --- level maps (timm auto_augment.py LEVEL_TO_ARG) -----------------------
# The "increasing" variants (timm _RAND_INCREASING_TRANSFORMS) make op
# strength monotone in M; ops read the flavor from the `inc` flag.

def _enhance_level(level: float, rng, inc=False) -> float:
    if inc:
        return 1.0 + _randomly_negate((level / _LEVEL_DENOM) * 0.9, rng)
    return (level / _LEVEL_DENOM) * 1.8 + 0.1


def _shear_level(level: float, rng) -> float:
    return _randomly_negate((level / _LEVEL_DENOM) * 0.3, rng)


def _translate_rel_level(level: float, rng) -> float:
    return _randomly_negate((level / _LEVEL_DENOM) * 0.45, rng)


def _rotate_level(level: float, rng) -> float:
    return _randomly_negate((level / _LEVEL_DENOM) * 30.0, rng)


def _posterize_level(level: float, rng, inc=False) -> int:
    bits = int((level / _LEVEL_DENOM) * 4)
    return 4 - bits if inc else bits


def _solarize_level(level: float, rng, inc=False) -> int:
    t = min(256, int((level / _LEVEL_DENOM) * 256))
    return 256 - t if inc else t


def _solarize_add_level(level: float, rng) -> int:
    return min(128, int((level / _LEVEL_DENOM) * 110))


# --- ops (uint8 HWC arrays through image_ops) -----------------------------

def _interp(rng):
    return (ops.BILINEAR, ops.BICUBIC)[int(rng.integers(0, 2))]


def _affine(img, matrix, fill, rng):
    return ops.affine(img, matrix, fill, _interp(rng))


def _op_auto_contrast(img, level, fill, rng, inc=False):
    return ops.autocontrast(img)


def _op_equalize(img, level, fill, rng, inc=False):
    return ops.equalize(img)


def _op_invert(img, level, fill, rng, inc=False):
    return ops.invert(img)


def _op_rotate(img, level, fill, rng, inc=False):
    deg = _rotate_level(level, rng)
    return ops.rotate(img, deg, fill, _interp(rng))


def _op_posterize(img, level, fill, rng, inc=False):
    bits = _posterize_level(level, rng, inc)
    if bits >= 8:
        return img
    return ops.posterize(img, max(1, bits))   # JAX's clamp (ADVICE r5), kept


def _op_solarize(img, level, fill, rng, inc=False):
    return ops.solarize(img, _solarize_level(level, rng, inc))


def _op_solarize_add(img, level, fill, rng, inc=False):
    add = _solarize_add_level(level, rng)
    arr = np.asarray(img, np.int32)
    out = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
    return out.astype(np.uint8)


def _op_color(img, level, fill, rng, inc=False):
    return ops.enhance_color(img, _enhance_level(level, rng, inc))


def _op_contrast(img, level, fill, rng, inc=False):
    return ops.enhance_contrast(img, _enhance_level(level, rng, inc))


def _op_brightness(img, level, fill, rng, inc=False):
    return ops.enhance_brightness(img, _enhance_level(level, rng, inc))


def _op_sharpness(img, level, fill, rng, inc=False):
    return ops.enhance_sharpness(img, _enhance_level(level, rng, inc))


def _op_shear_x(img, level, fill, rng, inc=False):
    v = _shear_level(level, rng)
    return _affine(img, (1, v, 0, 0, 1, 0), fill, rng)


def _op_shear_y(img, level, fill, rng, inc=False):
    v = _shear_level(level, rng)
    return _affine(img, (1, 0, 0, v, 1, 0), fill, rng)


def _op_translate_x_rel(img, level, fill, rng, inc=False):
    px = _translate_rel_level(level, rng) * img.shape[1]
    return _affine(img, (1, 0, px, 0, 1, 0), fill, rng)


def _op_translate_y_rel(img, level, fill, rng, inc=False):
    px = _translate_rel_level(level, rng) * img.shape[0]
    return _affine(img, (1, 0, 0, 0, 1, px), fill, rng)


# timm _RAND_TRANSFORMS (auto_augment.py): the rand-m9-mstd0.5 pool.
RAND_TRANSFORMS: Tuple[Tuple[str, object], ...] = (
    ("AutoContrast", _op_auto_contrast),
    ("Equalize", _op_equalize),
    ("Invert", _op_invert),
    ("Rotate", _op_rotate),
    ("Posterize", _op_posterize),
    ("Solarize", _op_solarize),
    ("SolarizeAdd", _op_solarize_add),
    ("Color", _op_color),
    ("Contrast", _op_contrast),
    ("Brightness", _op_brightness),
    ("Sharpness", _op_sharpness),
    ("ShearX", _op_shear_x),
    ("ShearY", _op_shear_y),
    ("TranslateXRel", _op_translate_x_rel),
    ("TranslateYRel", _op_translate_y_rel),
)


class RandAugment:
    """timm ``rand-mM-mstdS`` on uint8 HWC arrays.

    ``num_layers`` ops drawn uniformly with replacement; each applies with
    probability ``prob``; per-application magnitude ``gauss(M, mstd)``
    clamped to [0, 10] (``mstd = inf`` draws uniform [0, M]).
    """

    def __init__(self, magnitude: float = 9.0, mstd: float = 0.5,
                 num_layers: int = 2, prob: float = 0.5,
                 increasing: bool = False,
                 fill: Sequence[int] = IMAGENET_FILL):
        self.magnitude = float(magnitude)
        self.mstd = float(mstd)
        self.num_layers = int(num_layers)
        self.prob = float(prob)
        self.increasing = bool(increasing)
        self.fill = tuple(int(v) for v in fill)

    def _sample_level(self, rng: np.random.Generator) -> float:
        m = self.magnitude
        if self.mstd > 0:
            if np.isinf(self.mstd):
                m = rng.uniform(0, m)
            else:
                m = rng.normal(m, self.mstd)
        return float(min(max(m, 0.0), _LEVEL_DENOM))

    def __call__(self, img: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        for _ in range(self.num_layers):
            i = int(rng.integers(0, len(RAND_TRANSFORMS)))
            if rng.random() > self.prob:
                continue
            _, fn = RAND_TRANSFORMS[i]
            img = fn(img, self._sample_level(rng), self.fill, rng,
                     inc=self.increasing)
        return img


def parse_rand_augment(config: str) -> Optional[RandAugment]:
    """Parse a timm-style config string (``rand-m9-mstd0.5-inc1`` etc).

    Returns None for falsy / 'none'.  Matches the subset of timm's
    ``rand_augment_transform`` grammar the reference recipe uses
    (``quant_train.py:117`` default ``rand-m9-mstd0.5-inc1``).
    """
    if not config or config.lower() in ("none", "no", "0", "false"):
        return None
    parts = config.split("-")
    if parts[0] != "rand":
        raise ValueError(f"unsupported auto-augment policy {config!r} "
                         "(only 'rand-...' RandAugment is implemented)")
    kw = {}
    for tok in parts[1:]:
        if tok.startswith("mstd"):
            kw["mstd"] = float(tok[4:])
        elif tok.startswith("m"):
            kw["magnitude"] = float(tok[1:])
        elif tok.startswith("n"):
            kw["num_layers"] = int(tok[1:])
        elif tok.startswith("p"):
            kw["prob"] = float(tok[1:])
        elif tok.startswith("inc"):
            kw["increasing"] = tok[3:] not in ("", "0")
        else:
            raise ValueError(f"unknown rand-augment token {tok!r}")
    return RandAugment(**kw)
