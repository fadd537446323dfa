"""Build the CUDA sources of ``ivit_tpu_torch/csrc`` with nvcc and bind them
with ctypes.

Each ``.cu`` becomes its own shared library with a plain C interface,
compiled for ``sm_90a`` with ``--fmad=false`` (so every multiply that feeds
an add rounds as written, as the exactness helpers require).  The libraries
go to ``build/ivit_tpu_torch/`` beside the package, named by a hash of all
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  All sources are compiled in parallel, one nvcc each, at the first
call that needs a kernel.  Each compiler's output (ptxas's register and
spill report) is kept beside its library, so it can be read whether this
process built the library or found it built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_ROOT, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_ROOT), "build", "ivit_tpu_torch")
SOURCES = {"mlp_block": "mlp_block.cu", "attn_block": "attn_block.cu",
           "swin_attn_block": "swin_attn_block.cu", "nonlinear": "nonlinear.cu"}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mlp_block": {"ivit_mlp_block": [_P] * 16 + [_I] * 10 + [_P] * 4},
    "attn_block": {"ivit_attn_block": [_P] * 20 + [_I] * 14 + [_P] * 2 + [_I, _P]},
    "swin_attn_block": {"ivit_swin_attn_block": [_P] * 23 + [_I] * 10 + [_P] * 2
                        + [_I, _P, _P]},
    "nonlinear": {"ivit_shiftmax": [_P] * 3 + [_I] * 5 + [_P],
                  "ivit_shift_gelu_requant": [_P] * 4 + [_I] * 6 + [_P, _P],
                  "ivit_ln_requant": [_P, ctypes.c_longlong] + [_P] * 4 + [_I] * 4
                  + [_P]},
}

_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels are built "
                           "from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _lib_path(name: str, digest: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _log_path(name: str, digest: str) -> str:
    return _lib_path(name, digest)[:-3] + ".log"


def build_all() -> dict:
    """Compile every source not yet built, all nvcc processes at once.

    Returns ``{name: seconds}`` for the sources compiled by this call and
    keeps each compiler's output (register and spill report) beside its
    library (:func:`compiler_logs`).  Raises with the compiler's output on
    failure."""
    digest = _digest()
    todo = {n: s for n, s in SOURCES.items()
            if not os.path.exists(_lib_path(n, digest))}
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, src in todo.items():
        tmp = _lib_path(name, digest) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    times, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
        else:
            with open(_log_path(name, digest), "w") as f:
                f.write(out)
            os.replace(tmp, _lib_path(name, digest))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def compiler_logs() -> dict:
    """``{name: nvcc output}`` of every source's current library, building
    what is missing."""
    build_all()
    digest = _digest()
    out = {}
    for name in SOURCES:
        with open(_log_path(name, digest)) as f:
            out[name] = f.read()
    return out


def ptxas_report(log: str) -> list:
    """Registers and spill bytes of every kernel in one ``-Xptxas -v`` log:
    ``[{"kernel", "registers", "spill_bytes"}, ...]``."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append({"kernel": name[:72], "registers": int(m.group(1)),
                        "spill_bytes": spill})
            name = None
    return out


def library(name: str):
    """The loaded ctypes library of kernel ``name``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(_lib_path(name, _digest()))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def error_string(err: int) -> str:
    """``cudaGetErrorString`` of a CUDA runtime error code."""
    lib = library("mlp_block")
    lib.ivit_error_string.restype = ctypes.c_char_p
    lib.ivit_error_string.argtypes = [ctypes.c_int]
    return lib.ivit_error_string(err).decode()
