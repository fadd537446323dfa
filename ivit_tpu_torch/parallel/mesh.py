"""Device mesh and sharding layout for data- and tensor-parallel serving and
training (counterpart of ``ivit_tpu/parallel/mesh.py``).

A :class:`Mesh` is a dp x tp grid in JAX's layout: the entries reshaped
row-major, the ``data`` axis first.  Built inside one process
(``devices=`` given, or no ``torch.distributed`` world) its entries are
devices, which the server runs replicas on.  Built inside a world its
entries are the ranks, one device each (the one
:func:`~ivit_tpu_torch.parallel.launch.init_process_group` gave the
rank): rank ``d * tp + m`` holds row ``d`` of the data axis and column
``m`` of the model axis, and the mesh holds the data-axis and model-axis
process groups.

The sharding functions return JAX's ``PartitionSpec`` entries as tuples,
leaf for leaf: ``(None, "model")`` for a column-sharded kernel (``qkv``,
``fc1``), ``("model",)`` for its bias, ``("model", None)`` for a
row-sharded kernel (``proj``, ``fc2``; ``patch_embed/proj`` stays
replicated), ``()`` for everything else; the engine's leaves likewise.

The local shards are head-aligned.  JAX cuts ``qkv``'s 3C columns into
contiguous blocks and GSPMD reshards them for the ``reshape(B, N, 3, H,
Dh)``; nothing reshards for free here, so model rank ``r`` takes, of each
of q, k and v, the columns of heads ``[r H/tp, (r+1) H/tp)`` (the same for
``qkv``'s bias and ``m_qkv``), and ``proj``'s matching rows; ``fc1``'s
columns and ``fc2``'s rows are contiguous blocks.  In the sim, Swin's
``relative_position_bias_table`` ``[(2w-1)**2, heads]`` is cut by head as
well: the one leaf whose local shard differs from its JAX spec (JAX
replicates it and gathers the heads it needs), since the port's scores are
head-sharded.  ``tp`` must divide every attention's heads and every MLP's
hidden width (``ValueError`` naming the width otherwise): GSPMD takes any
width, this layout does not.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import collectives as C

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A [data, model] grid of devices (one process) or of ranks (a world).

    ``devices``: the [dp, tp] object array; ``shape``: ``{"data": dp,
    "model": tp}``.  A rank mesh (``distributed``) also has ``rank``, its
    ``data_index`` and ``model_index``, ``device``, ``backend`` and the
    ``data_group`` / ``model_group`` / ``world_group`` it reduces over."""

    def __init__(self, devices: np.ndarray, *, distributed=False, rank=None,
                 device=None, groups=None):
        self.devices = devices
        self.dp, self.tp = devices.shape
        self.distributed = distributed
        self.rank = rank
        self.device = device
        self.data_group, self.model_group, self.world_group = groups or (None,) * 3
        self.data_index, self.model_index = ((rank // self.tp, rank % self.tp)
                                             if distributed else (0, 0))

    @property
    def backend(self):
        return dist.get_backend() if self.distributed else None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    def __repr__(self):
        kind = f"ranks, rank {self.rank}" if self.distributed else "devices"
        return f"Mesh(dp={self.dp}, tp={self.tp}, {kind})"


def _rank_groups(dp, tp):
    """The model-axis groups (one per data row) and the data-axis groups
    (one per model column): every rank calls ``new_group`` for every
    group, in the same order, as every rank makes the same meshes in the
    same order.  Nothing is cached: a group outlives no world."""
    grid = np.arange(dp * tp).reshape(dp, tp)
    rows = [dist.new_group(grid[d].tolist()) for d in range(dp)]
    cols = [dist.new_group(grid[:, m].tolist()) for m in range(tp)]
    return rows, cols


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh shaped [data, model] (``dp`` defaults to fill).

    ``devices`` given: a mesh of those devices in this process (duplicates
    allowed: ``["cuda:0", "cuda:0"]`` runs two replicas on one card).
    Otherwise, inside a ``torch.distributed`` world, a mesh of its ranks;
    outside one, of the visible cards (none raises: a mesh never carries
    on on the CPU for want of a card)."""
    from .launch import rank_device

    if devices is None and dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if dp is None:
            dp = world // tp
        if dp * tp != world:
            raise ValueError(f"dp*tp = {dp}*{tp} != {world} ranks")
        rows, cols = _rank_groups(dp, tp)
        rank = dist.get_rank()
        d, m = rank // tp, rank % tp
        return Mesh(np.arange(world).reshape(dp, tp), distributed=True, rank=rank,
                    device=rank_device(), groups=(cols[m], rows[d], None))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh over the visible cards found none; pass "
                               "devices=['cpu', ...] to mesh the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if dp is None:
        dp = len(devices) // tp
    if dp * tp != len(devices):
        raise ValueError(f"dp*tp = {dp}*{tp} != {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, tp))


def replicated(mesh: Mesh) -> tuple:
    return ()


def batch_sharding(mesh: Mesh) -> tuple:
    """Leading (batch) axis sharded over the data axis."""
    return (DATA_AXIS,)


# ---------------------------------------------------------------------------
# The tensor-parallel layout: JAX's specs, and the port's head-aligned cuts
# ---------------------------------------------------------------------------

_COL_SHARDED = ("qkv", "fc1")
_ROW_SHARDED = ("proj", "fc2")
_ENGINE_COL = ("qkv_w", "fc1_w")
_ENGINE_COL_VEC = ("qkv_b", "m_qkv", "fc1_b", "m_fc1")
_ENGINE_ROW = ("proj_w", "fc2_w")
_TABLE = "relative_position_bias_table"
# the Swin engine's per-head bias addend [heads, n, n]: cut by head, as the
# sim's table (JAX's spec replicates both)
_ENGINE_HEAD_ROWS = "rel_bias_addend"


def _param_spec(names) -> tuple:
    for n in names:
        if n in _COL_SHARDED and names[-1] == "kernel":
            return (None, MODEL_AXIS)
        if n in _COL_SHARDED and names[-1] == "bias":
            return (MODEL_AXIS,)
        if n in _ROW_SHARDED and names[-1] == "kernel":
            # patch_embed/proj is a conv kernel [kh, kw, cin, D]: replicate
            if "patch_embed" in names:
                return ()
            return (MODEL_AXIS, None)
    return ()


def _engine_param_spec(names) -> tuple:
    leaf = names[-1] if names else ""
    if leaf in _ENGINE_COL:
        return (None, MODEL_AXIS)
    if leaf in _ENGINE_COL_VEC:
        return (MODEL_AXIS,)
    if leaf in _ENGINE_ROW:
        return (MODEL_AXIS, None)
    return ()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(tree, mesh: Mesh):
    """JAX's spec of each leaf of a QAT sim's tree (params, quant_stats or
    the optimizer state: the names decide), as tuples."""
    return _map_with_path(lambda path, leaf: _param_spec(path), tree)


def engine_param_shardings(params, mesh: Mesh):
    """JAX's spec of each leaf of a frozen ``EngineSpec``'s params."""
    return _map_with_path(lambda path, leaf: _engine_param_spec(path), params)


def _sim_cut(names):
    """How a sim leaf is cut: (axis, qkv-style) or None (replicated)."""
    spec = _param_spec(names)
    if spec == (None, MODEL_AXIS):
        return -1, "qkv" in names
    if spec == (MODEL_AXIS,):
        return 0, "qkv" in names
    if spec == (MODEL_AXIS, None):
        return 0, False
    if names and names[-1] == _TABLE:
        return -1, False
    return None


def _engine_cut(names):
    spec = _engine_param_spec(names)
    if spec == (None, MODEL_AXIS):
        return -1, names[-1] == "qkv_w"
    if spec == (MODEL_AXIS,):
        return 0, names[-1] in ("qkv_b", "m_qkv")
    if spec == (MODEL_AXIS, None) or names[-1] == _ENGINE_HEAD_ROWS:
        return 0, False
    return None


def is_model_sharded(names) -> bool:
    """Whether a sim leaf (params, or the optimizer state's mirror of them)
    is cut over the model axis locally."""
    return _sim_cut(tuple(names)) is not None


def _local(t, cut, r, tp):
    """Model rank ``r``'s shard of ``t`` (a tensor or numpy array)."""
    if cut is None or tp == 1:
        return t
    axis, qkv = cut
    axis = axis % t.ndim
    n = t.shape[axis]
    if qkv:
        # q, k and v each cut into tp blocks: this rank's heads of each
        shape = t.shape[:axis] + (3, n // 3) + t.shape[axis + 1:]
        w = n // 3 // tp
        part = t.reshape(shape)
        idx = (slice(None),) * (axis + 1) + (slice(r * w, (r + 1) * w),)
        out = part[idx]
        return out.reshape(t.shape[:axis] + (3 * w,) + t.shape[axis + 1:])
    w = n // tp
    idx = (slice(None),) * axis + (slice(r * w, (r + 1) * w),)
    return t[idx]


def _copy(t):
    if isinstance(t, torch.Tensor):
        return t.contiguous().clone()
    return np.ascontiguousarray(t) if isinstance(t, np.ndarray) else t


def _join(parts, cut):
    """The inverse of :func:`_local`: the tp shards, in model order, back
    into the full leaf."""
    axis, qkv = cut
    axis = axis % parts[0].ndim
    if not qkv:
        return torch.cat(parts, axis)
    split = [p.reshape(p.shape[:axis] + (3, p.shape[axis] // 3) + p.shape[axis + 1:])
             for p in parts]
    full = torch.cat(split, axis + 1)
    return full.reshape(full.shape[:axis] + (-1,) + full.shape[axis + 2:])


def check_tp_widths(widths, tp):
    """``tp`` divides each ``(what, width)``; ``ValueError`` naming the
    first it does not."""
    for what, width in widths:
        if width % tp:
            raise ValueError(f"tp={tp} does not divide {what} {width}: the "
                             "port's tensor-parallel shards are head-aligned "
                             "(JAX's GSPMD takes any width)")


def check_model_tp(model, tp: int):
    """``tp`` divides every attention's heads and every MLP's hidden width
    of a sim; ``ValueError`` naming the width otherwise."""
    widths = []
    for name, mod in model.named_modules():
        if hasattr(mod, "num_heads") and hasattr(mod, "qkv"):
            widths.append((f"the heads of {name}", mod.num_heads))
        if hasattr(mod, "fc1") and hasattr(mod, "fc2"):
            widths.append((f"the hidden width of {name}", mod.fc1.kernel.shape[1]))
    check_tp_widths(widths, tp)


def check_engine_tp(config, tp: int):
    """``tp`` divides a ViT engine config's heads and hidden width."""
    check_tp_widths([("num_heads", config.num_heads),
                    ("the MLP hidden width", int(config.embed_dim * config.mlp_ratio))],
                   tp)


def shard_variables(variables, mesh: Mesh):
    """This rank's local shards of a sim's tree (params, quant_stats or the
    optimizer state) per the TP layout; returns ``(local tree, specs)``, as
    JAX's returns the placed tree and its shardings."""
    r = mesh.model_index
    local = _map_with_path(
        lambda path, leaf: _copy(_local(leaf, _sim_cut(path), r, mesh.tp)), variables)
    return local, param_shardings(variables, mesh)


def shard_engine_params(params, mesh: Mesh):
    """This rank's local shards of an engine spec's params (``tp`` must
    divide the heads and the hidden width: :func:`check_engine_tp`);
    returns ``(local params, specs)``."""
    r = mesh.model_index
    local = _map_with_path(
        lambda path, leaf: _copy(_local(leaf, _engine_cut(path), r, mesh.tp)), params)
    return local, engine_param_shardings(params, mesh)


def gather_variables(local, mesh: Mesh):
    """The inverse of :func:`shard_variables` on a rank mesh: every sharded
    leaf all-gathered over the model axis and joined (every rank calls it;
    every rank gets the full tree)."""
    def full(path, leaf):
        cut = _sim_cut(path)
        if cut is None or mesh.tp == 1 or not isinstance(leaf, torch.Tensor):
            return leaf
        with C.use(mesh):
            parts = C.all_gather(leaf.detach().unsqueeze(0), "model", dim=0)
        return _join(list(parts.unbind(0)), cut)
    return _map_with_path(full, local)


# ---------------------------------------------------------------------------
# A sim module on a rank mesh
# ---------------------------------------------------------------------------

# the modules whose input is cut over the model axis (head or hidden
# shards) in a tensor-parallel sim, by their name's last parts
_MODEL_SHARDED_SITES = (
    ("attn", "qact1"), ("attn", "qact_attn1"), ("attn", "qact2"),
    ("attn", "qact_table"), ("attn", "int_softmax"), ("int_softmax", "act"),
    ("mlp", "qact_gelu"), ("mlp", "act"), ("mlp", "qact1"),
)
_SWIN_MODEL_SHARDED = (("attn", "qact3"),)
# the QuantActs whose input is a parameter, not the batch
_UNBATCHED_SITES = ("qact_pos", "qact_table")


def _tp_role(names):
    if names[-1] in _COL_SHARDED:
        return "col"
    if names[-1] in _ROW_SHARDED and "patch_embed" not in names:
        return "row"
    return None


def shard_module(model, mesh: Mesh):
    """Put a sim on a rank mesh, in place: each parameter replaced by this
    rank's shard (:func:`shard_variables`' cut), the sharded sites marked,
    ``model.mesh`` set (its forward then makes the mesh active; it takes
    this rank's rows of the batch, :func:`local_rows`); returns ``model``.  ``tp`` must divide
    every heads and hidden width (:func:`check_model_tp`)."""
    if not mesh.distributed:
        raise ValueError("shard_module needs a mesh of ranks (make_mesh inside "
                         "a torch.distributed world)")
    check_model_tp(model, mesh.tp)
    swin = hasattr(model, "stages")
    for name, mod in model.named_modules():
        names = tuple(name.split(".")) if name else ()
        if type(mod).__name__ == "QuantLinear" and names:
            mod.tp = _tp_role(names)
        tail = names[-2:]
        if tail in _MODEL_SHARDED_SITES or (swin and tail in _SWIN_MODEL_SHARDED):
            mod.model_sharded = True
        if names and names[-1] in _UNBATCHED_SITES:
            mod.batch_sharded = False
    if mesh.tp > 1:
        from ..models.convert import _flax_path
        with torch.no_grad():
            for name, p in list(model.named_parameters()):
                cut = _sim_cut(_flax_path(name))
                if cut is None:
                    continue
                *owner, leaf = name.split(".")
                mod = model.get_submodule(".".join(owner)) if owner else model
                shard = _local(p.detach(), cut, mesh.model_index, mesh.tp)
                setattr(mod, leaf, torch.nn.Parameter(shard.contiguous().clone(),
                                                      requires_grad=p.requires_grad))
    model.mesh = mesh
    return model


def local_rows(x, mesh: Optional[Mesh]):
    """This rank's rows of the global batch (the data axis's contiguous
    blocks); ``x`` itself without a rank mesh."""
    if mesh is None or not mesh.distributed or mesh.dp == 1:
        return x
    if len(x) % mesh.dp:
        raise ValueError(f"batch {len(x)} is not divisible by dp={mesh.dp}")
    w = len(x) // mesh.dp
    return x[mesh.data_index * w:(mesh.data_index + 1) * w]
