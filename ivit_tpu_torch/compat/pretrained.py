"""Pretrained float-checkpoint ingestion by model name (counterpart of
``ivit_tpu/compat/pretrained.py``).

The reference's factories download timm/DeiT ``.pth`` checkpoints and
Google ViT ``.npz`` (Flax) files.  ``load_pretrained(model, name)`` merges
such a file into the QAT sim's parameters -- the QuantAct statistics keep
their values, ready for calibration.

The port never downloads: it opens no network connection.
:func:`fetch_pretrained` only finds the file, at ``local_path`` or in the
cache directory JAX's loader would use (under ``ivit_tpu_torch``), and
raises naming the URL and the path to drop the file at when it is not
there.
"""

from __future__ import annotations

import os

# name -> (url, kind); the reference's factories' URLs
PRETRAINED_URLS = {
    "deit_tiny_patch16_224": (
        "https://dl.fbaipublicfiles.com/deit/"
        "deit_tiny_patch16_224-a1311bcf.pth", "torch"),
    "deit_small_patch16_224": (
        "https://dl.fbaipublicfiles.com/deit/"
        "deit_small_patch16_224-cd65a155.pth", "torch"),
    "deit_base_patch16_224": (
        "https://dl.fbaipublicfiles.com/deit/"
        "deit_base_patch16_224-b5f2ef4d.pth", "torch"),
    "vit_base_patch16_224": (
        "https://storage.googleapis.com/vit_models/augreg/"
        "B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0"
        "--imagenet2012-steps_20k-lr_0.01-res_224.npz", "npz"),
    "vit_large_patch16_224": (
        "https://storage.googleapis.com/vit_models/augreg/"
        "L_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.1-sd_0.1"
        "--imagenet2012-steps_20k-lr_0.01-res_224.npz", "npz"),
}


def _default_cache_dir():
    return os.path.join(os.environ.get("XDG_CACHE_HOME",
                                       os.path.expanduser("~/.cache")),
                        "ivit_tpu_torch", "pretrained")


def fetch_pretrained(name: str, cache_dir: str = None) -> str:
    """The local path of the named checkpoint in ``cache_dir`` (default
    ``$XDG_CACHE_HOME/ivit_tpu_torch/pretrained``).  Raises
    ``FileNotFoundError`` naming the URL and the path to put the file at
    when it is not there: the port does not download."""
    if name not in PRETRAINED_URLS:
        raise KeyError(f"no pretrained URL for {name!r}; known: "
                       f"{sorted(PRETRAINED_URLS)}")
    url, _ = PRETRAINED_URLS[name]
    dest = os.path.join(cache_dir or _default_cache_dir(), os.path.basename(url))
    if not os.path.exists(dest):
        raise FileNotFoundError(
            f"{name}: no local copy at {dest}. The port does not download; "
            f"fetch {url} elsewhere and drop it at {dest}, or pass "
            f"local_path=")
    return dest


def load_pretrained(model, name: str, *, local_path=None, cache_dir=None,
                    strict: bool = False):
    """Merge the named pretrained float checkpoint into the sim ``model``,
    in place.

    Returns ``(variables, report)`` like the underlying loaders.  ``strict``
    defaults to False: float checkpoints lack every quantization buffer
    (those keep the sim's values -- run calibration next), and classifier
    heads may be sized differently.
    """
    if name not in PRETRAINED_URLS:
        raise KeyError(f"no pretrained mapping for {name!r}")
    _, kind = PRETRAINED_URLS[name]
    path = local_path or fetch_pretrained(name, cache_dir)
    if kind == "npz":
        from .flax_npz import load_npz_into_model
        return load_npz_into_model(model, path, strict=strict)
    from .torch_ckpt import load_into_model
    return load_into_model(model, path, strict=strict)
