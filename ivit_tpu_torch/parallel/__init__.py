"""Data- and tensor-parallel layout, collectives and launch (counterpart of
``ivit_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    engine_param_shardings,
    gather_variables,
    local_rows,
    make_mesh,
    param_shardings,
    replicated,
    shard_engine_params,
    shard_module,
    shard_variables,
)
