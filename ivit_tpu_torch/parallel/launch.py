"""Process launch for the sharded paths (where JAX has
``jax.distributed.initialize``).

* :func:`spawn` runs ``fn(rank, *args)`` in ``world`` new processes
  (``torch.multiprocessing``, the spawn start method) joined by a ``file://`` rendezvous,
  each with one torch intra-op thread and its own device, and re-raises
  a rank's exception in the parent; it returns each rank's return value.
* :func:`init_from_env` joins a torchrun-style ``env://`` world
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``) on ``cuda:LOCAL_RANK``.

The backend is NCCL for a CUDA device and gloo for the CPU unless the
caller names it: ranks that share one card take gloo (NCCL refuses two
ranks on one device).  A rank's device is the one it was given
(:func:`rank_device`); a mesh never picks another.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from .. import resolve_device

_DEVICE = None


def init_process_group(rank: int, world: int, backend=None, device=None,
                       init_method=None):
    """Join the world as ``rank`` on ``device`` (default ``cuda``; raises
    without a card unless ``"cpu"``)."""
    global _DEVICE
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    _DEVICE = dev
    return dev


def rank_device() -> torch.device:
    """This rank's device, as :func:`init_process_group` set it."""
    if _DEVICE is None:
        raise RuntimeError("the torch.distributed world was not joined through "
                           "ivit_tpu_torch.parallel.launch (spawn, init_from_env "
                           "or init_process_group), so this rank has no device")
    return _DEVICE


def init_from_env(device=None, backend=None) -> torch.device:
    """Join a torchrun-style ``env://`` world: the rank on
    ``cuda:LOCAL_RANK``, or on the CPU with ``device="cpu"``."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but this host has "
                               f"{torch.cuda.device_count()} card(s)")
        dev = torch.device("cuda", local)
    return init_process_group(rank, world, backend, dev, "env://")


def _entry(rank, fn, world, backend, devices, init_file, out_dir, args):
    torch.set_num_threads(1)
    init_process_group(rank, world, backend, devices[rank], f"file://{init_file}")
    try:
        result = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn, world: int, backend=None, devices=None, init_file=None, args=(),
          timeout=None):
    """Run ``fn(rank, *args)`` on ``world`` processes; returns the ranks'
    return values in rank order.

    ``fn`` must be importable by name (a module-level function: the
    children start fresh interpreters).  ``devices``: one per rank
    (default ``cuda:0 .. cuda:world-1``, which must exist); ``init_file``:
    the rendezvous file, which must not exist yet (default: one in a new
    temporary directory); ``timeout`` (seconds): past it every rank is
    terminated and ``TimeoutError`` raised."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world:
            raise RuntimeError(f"{world} ranks need {world} cards; this host has "
                               f"{n} (name devices= to share one, or run on the CPU)")
        devices = [f"cuda:{i}" for i in range(world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    tmp = tempfile.mkdtemp(prefix="ivit_spawn_")
    try:
        init_file = init_file or os.path.join(tmp, "rendezvous")
        ctx = torch.multiprocessing.start_processes(
            _entry, args=(fn, world, backend, [str(d) for d in devices],
                          os.path.abspath(init_file), tmp, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.2):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
