"""The collectives of the sharded paths, over ``torch.distributed``.

JAX gets every cross-shard reduction from GSPMD: a ``NamedSharding``
annotation, and XLA inserts the collective.  Here each one is explicit,
and each leaves the bits as the single-device run has them:

* :func:`all_reduce_exact` -- int32 SUM, wrapping exactly as a
  single-device int32 sum wraps (the engine's row-sharded ``proj`` /
  ``fc2`` accumulators);
* :func:`reduce_min` / :func:`reduce_max` / :func:`reduce_range` -- the
  QuantAct ranges and every other max or min over a sharded axis;
* :func:`all_gather` -- along a named axis, in the axis's rank order
  (logits over the data axis, a percentile's elements, the shards of a
  checkpoint);
* :func:`copy_to_model` / :func:`reduce_from_model` -- Megatron's f and g:
  identity forward and all-reduce backward before a column-sharded GEMM,
  all-reduce forward and identity backward after a row-sharded one (the
  sim's f32 partial sums are integers under 2**24 where the single-device
  sim is exact, so the forward keeps its bits);
* :func:`model_row_max` -- ShiftGELU's row max over a hidden row cut into
  column shards, with amax's gradient (the shards' parts of it summed,
  then split evenly between the row's ties over every shard).

Every helper acts on the mesh made active by :func:`use` and does nothing
without one (or over an axis of width 1), so the single-device paths run
as before.  The active mesh and the :func:`timed` switch are context
variables: a thread sees only its own ``use`` blocks (a new thread starts
with none), so a server's batcher running ``use(None)`` leaves a sharded
forward on another thread its mesh.  gloo moves a CUDA tensor through host memory itself: on the
H100 machine's torch it takes CUDA tensors in ``all_reduce`` (SUM, MIN,
MAX; int32 and f32) and ``all_gather`` (``tests/test_torch_port_cuda.py``
pins that), so the helpers hand them over as they are.  That copy is
transport: every computation stays on the tensor's device.

:data:`STATS` counts each collective and its milliseconds on the host
clock (the device synchronized around each call while :func:`timed` is
on, so a card's queued work is not charged to it).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import time

import torch
import torch.distributed as dist

_ACTIVE = contextvars.ContextVar("ivit_active_mesh", default=None)

STATS = collections.defaultdict(lambda: {"count": 0, "ms": 0.0})
_TIMED = contextvars.ContextVar("ivit_collectives_timed", default=False)


@contextlib.contextmanager
def use(mesh):
    """Make ``mesh`` (a rank mesh, or None) the active one in this thread
    while the block runs; the helpers reduce over its groups."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.distributed else None)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active():
    """This thread's active rank mesh, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def timed(on=True):
    """Synchronize the device around each collective this thread runs while
    the block runs, so :data:`STATS` holds each one's own time."""
    token = _TIMED.set(on)
    try:
        yield
    finally:
        _TIMED.reset(token)


def reset_stats():
    STATS.clear()


def _axes(mesh, axis):
    """(group, width) of ``axis``: "data", "model" or "both"."""
    if axis == "data":
        return mesh.data_group, mesh.dp
    if axis == "model":
        return mesh.model_group, mesh.tp
    if axis == "both":
        return mesh.world_group, mesh.dp * mesh.tp
    raise ValueError(f"axis {axis!r}: want 'data', 'model' or 'both'")


@contextlib.contextmanager
def _clock(name, t):
    sync = _TIMED.get() and t.is_cuda
    if sync:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if sync:
        torch.cuda.synchronize(t.device)
    rec = STATS[name]
    rec["count"] += 1
    rec["ms"] += (time.perf_counter() - t0) * 1e3


def _all_reduce(t, op, axis, name, mesh=None):
    """``t`` reduced over ``axis`` of ``mesh`` (default: the active one; a
    new tensor, or ``t`` itself where there is nothing to reduce)."""
    mesh = mesh or _ACTIVE.get()
    if mesh is None:
        return t
    group, width = _axes(mesh, axis)
    if width == 1:
        return t
    out = t.clone().contiguous()
    with _clock(name, t):
        dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_exact(t, axis="model"):
    """int32 SUM over ``axis``: wraps as the single-device int32 sum does."""
    if t.dtype != torch.int32:
        raise TypeError(f"all_reduce_exact sums int32, got {t.dtype}")
    return _all_reduce(t, dist.ReduceOp.SUM, axis, "all_reduce_sum_i32")


def all_reduce_sum(t, axis, mesh=None):
    """SUM over ``axis`` (f32 partial sums, int64 counts)."""
    return _all_reduce(t, dist.ReduceOp.SUM, axis, "all_reduce_sum", mesh)


def reduce_min(t, axis):
    return _all_reduce(t, dist.ReduceOp.MIN, axis, "all_reduce_min")


def reduce_max(t, axis):
    return _all_reduce(t, dist.ReduceOp.MAX, axis, "all_reduce_max")


def range_axis(model_sharded: bool, batch_sharded: bool = True):
    """Where a range runs: over the data axis for a tensor of the batch
    (an activation; not a parameter such as the position embedding), over
    the model axis for one whose features are cut there; None for neither."""
    if batch_sharded:
        return "both" if model_sharded else "data"
    return "model" if model_sharded else None


def reduce_range(cur_min, cur_max, model_sharded=False, batch_sharded=True):
    """A QuantAct's (min, max) over the active mesh: one MAX of
    ``[-min, max]`` (negation is exact)."""
    axis = range_axis(model_sharded, batch_sharded)
    if _ACTIVE.get() is None or axis is None:
        return cur_min, cur_max
    n = cur_min.numel()
    packed = reduce_max(torch.cat([-cur_min.reshape(-1), cur_max.reshape(-1)]), axis)
    return -packed[:n].reshape(cur_min.shape), packed[n:].reshape(cur_max.shape)


def all_gather(t, axis, dim=0):
    """``t`` from every rank of ``axis`` (None: ``t`` itself), concatenated
    along ``dim`` in the axis's rank order."""
    mesh = _ACTIVE.get()
    if mesh is None or axis is None:
        return t
    group, width = _axes(mesh, axis)
    if width == 1:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(width)]
    with _clock("all_gather", src):
        dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


# ---------------------------------------------------------------------------
# Tensor-parallel autograd pieces
# ---------------------------------------------------------------------------

# The backward runs after the forward has left the mesh's ``use`` block,
# and on the card on the autograd engine's own threads, whose context is
# empty: each function keeps the mesh its forward ran on.

class _CopyToModel(torch.autograd.Function):
    """f: identity forward, SUM over the model axis backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh = _ACTIVE.get()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, "model", ctx.mesh)


class _ReduceFromModel(torch.autograd.Function):
    """g: SUM over the model axis forward, identity backward."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g


def _model_cut():
    mesh = _ACTIVE.get()
    return mesh is not None and mesh.tp > 1


def copy_to_model(x):
    """The input of a column-sharded GEMM (f)."""
    return _CopyToModel.apply(x) if _model_cut() else x


def reduce_from_model(x):
    """The partial sums of a row-sharded GEMM, summed (g)."""
    return _ReduceFromModel.apply(x) if _model_cut() else x


class _ModelRowMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        m = reduce_max(torch.amax(x, dim=-1, keepdim=True), "model")
        ctx.mesh = _ACTIVE.get()
        if ctx.needs_input_grad[0]:
            mask = x == m
            count = all_reduce_sum(mask.sum(-1, keepdim=True, dtype=x.dtype),
                                   "model")
            ctx.save_for_backward(mask, count)
        return m

    @staticmethod
    def backward(ctx, g):
        mask, count = ctx.saved_tensors
        # each rank's columns used the max: their parts of its gradient are
        # summed; then torch's amax gradient, (grad / ties) * mask, the ties
        # over the whole row
        return (all_reduce_sum(g, "model", ctx.mesh) / count) * mask


def model_row_max(x):
    """``torch.amax(x, -1, keepdim=True)`` of the whole row whose columns are
    cut over the model axis (``x`` holds this rank's)."""
    if _model_cut():
        return _ModelRowMax.apply(x)
    return torch.amax(x, dim=-1, keepdim=True)
