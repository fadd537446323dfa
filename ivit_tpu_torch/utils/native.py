"""ctypes binding of the native C++ preprocessing runtime (counterpart of
``ivit_tpu/utils/native.py``).

``native/preproc.cpp`` provides multi-threaded bicubic resize +
center-crop + normalize for the eval data path.  The port compiles it
itself at first use, with ``g++`` and ``native/Makefile``'s flags, into
``build/ivit_tpu_torch/`` beside the package, named by a digest of the
source, the flags, the compiler and what ``-march=native`` means on this
host (a library built for one CPU is never loaded on another).  It never
loads ``native/libivit_preproc.so``, which ``make -C native`` builds for
the JAX package.  A failed build raises with the compiler's output: the
port does not fall back to the numpy resize quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from ..train.data import IMAGENET_MEAN, IMAGENET_STD

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "preproc.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "ivit_tpu_torch")
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]
LDFLAGS = ["-shared", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native preprocess library "
                           f"is compiled from {SOURCE} at first use")
    return cxx


def lib_path() -> str:
    """Where this host's build of the library goes (or already is)."""
    cxx = _compiler()
    target = subprocess.run([cxx, *CXXFLAGS, "-dM", "-E", "-x", "c++", "-"],
                            input=b"", capture_output=True, check=True).stdout
    version = subprocess.run([cxx, "--version"], capture_output=True, check=True).stdout
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode() + version + target)
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libivit_preproc-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this host's build exists; returns its
    path.  The compiler writes a private file that is then renamed into
    place, so concurrent builds do not see a partial library."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_compiler(), *CXXFLAGS, SOURCE, "-o", tmp, *LDFLAGS]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building the native preprocess library failed:\n"
                           f"{' '.join(cmd)}\n{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The library, built and loaded at the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.ivit_preprocess_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32,
            ]
            lib.ivit_preprocess_batch.restype = None
            _LIB = lib
        return _LIB


def available() -> bool:
    """True once the library is loaded (building it at the first call; a
    failed build raises with the compiler's output)."""
    return load_library() is not None


def preprocess_batch(images: Sequence[np.ndarray], out_size: int = 224,
                     num_threads: int = 8) -> np.ndarray:
    """Eval-preprocess a list of HWC uint8 images -> [N, S, S, 3] float32
    (resize the shorter side to ``out_size / 0.875``, centre crop,
    normalise), on ``num_threads`` native threads."""
    lib = load_library()
    n = len(images)
    heights = np.asarray([im.shape[0] for im in images], np.int32)
    widths = np.asarray([im.shape[1] for im in images], np.int32)
    sizes = (heights.astype(np.int64) * widths * 3)
    offsets = np.zeros(n, np.int64)
    offsets[1:] = np.cumsum(sizes)[:-1]
    data = np.empty(int(sizes.sum()), np.uint8)
    for i, im in enumerate(images):
        if im.ndim != 3 or im.shape[2] != 3 or im.dtype != np.uint8:
            raise ValueError(f"image {i}: expected HWC uint8 RGB, "
                             f"got {im.shape} {im.dtype}")
        data[offsets[i]:offsets[i] + sizes[i]] = im.reshape(-1)

    out = np.empty((n, out_size, out_size, 3), np.float32)
    mean = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
    std = np.ascontiguousarray(IMAGENET_STD, np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.ivit_preprocess_batch(
        ptr(data, ctypes.c_uint8), ptr(offsets, ctypes.c_int64),
        ptr(heights, ctypes.c_int32), ptr(widths, ctypes.c_int32),
        n, out_size, ptr(mean, ctypes.c_float), ptr(std, ctypes.c_float),
        ptr(out, ctypes.c_float), num_threads)
    return out
