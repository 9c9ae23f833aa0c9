"""Multi-device execution on ``torch.distributed`` (counterpart of
:mod:`trieste_tpu.parallel`).

Installing a mesh of more than one rank with :func:`set_global_mesh` (or the
:func:`global_mesh` context manager) shards every pool-shaped stage over the ranks: the
acquisition optimizer's seed pool and L-BFGS runs, the GPR, SGPR and SVGP restarts, the
HMC chains and the MC sample axis of a single-batch reparametrization sample. In the JAX
package XLA inserts the collectives; here each stage calls the helpers of
:mod:`~trieste_tpu_torch.parallel.collectives`. Every rank runs the same program with
its own replica of the model and the same random draws, so ``BayesianOptimizer``, the
rules, ``model.optimize`` and Ask/Tell pick up the mesh with no other change.

A multi-process run starts one process per device, each calling
:func:`initialize_multi_host` with its rank, then ``set_global_mesh(create_multi_host_mesh())``.
"""
from .collectives import gather_rows, local_slice, replicated_inputs, sharded_best
from .mesh import (
    POOL_AXIS,
    Mesh,
    create_mesh,
    create_multi_host_mesh,
    current_axis_sharding,
    current_pool_sharding,
    get_global_mesh,
    global_mesh,
    initialize_multi_host,
    pool_sharding,
    replicated,
    round_to_mesh,
    set_global_mesh,
    sharding_mesh,
)

__all__ = [
    "POOL_AXIS",
    "create_mesh",
    "create_multi_host_mesh",
    "current_axis_sharding",
    "current_pool_sharding",
    "initialize_multi_host",
    "get_global_mesh",
    "global_mesh",
    "pool_sharding",
    "replicated",
    "round_to_mesh",
    "set_global_mesh",
    "Mesh",
    "sharding_mesh",
    "local_slice",
    "gather_rows",
    "replicated_inputs",
    "sharded_best",
]
