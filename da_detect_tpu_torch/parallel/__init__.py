"""Multi-GPU training: data parallelism with DDP (``ddp.py``), and the
(data, space, model) mesh of the JAX package (``mesh.py``): spatial
partitioning of the backbone (``spatial.py``) and the tensor-parallel
column split (``tensor.py``), put on a model by ``parallelize``."""

from .ddp import (check_mesh, global_average, global_mean, global_sum,
                  init_distributed, shard, shutdown, spawn, unused_parameters,
                  wrap_train_forward)
from .mesh import (Mesh, batch_sharding, check_divisible, current_mesh,
                   data_axis_size, data_shard, data_sharding, init_mesh,
                   make_mesh, model_axis_size, put_batch, reduce_mesh_grads,
                   replicate, set_mesh, shard_batch)
from .spatial import partition_backbone
from .tensor import shard_model, split_plan


def parallelize(model, mesh=None, min_channels: int = 256):
    """Put ``model`` under ``mesh`` (default the current one) in place and
    return it: its wide leaves split over ``model`` (``shard_model``,
    leaves of at least ``min_channels``), its backbone on row shards over
    ``space`` (``partition_backbone``). Without a mesh, or at S = M = 1,
    the model is left as it is. Call it before the optimizer is made (it
    replaces the split parameters by their slices); a training step
    reduces its gradients over the data slice (``reduce_mesh_grads``)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or (mesh.space == 1 and mesh.model == 1):
        return model
    model._mesh = mesh
    model._tp_plan = shard_model(model, mesh, min_channels)
    if mesh.space > 1:
        model._space_partial = partition_backbone(model, mesh)
    return model


__all__ = ["Mesh", "batch_sharding", "check_divisible", "check_mesh",
           "current_mesh", "data_axis_size", "data_shard", "data_sharding",
           "global_average", "global_mean", "global_sum", "init_distributed",
           "init_mesh", "make_mesh", "model_axis_size", "parallelize",
           "partition_backbone", "put_batch", "reduce_mesh_grads", "replicate",
           "set_mesh", "shard", "shard_batch", "shard_model", "shutdown",
           "spawn", "split_plan", "unused_parameters", "wrap_train_forward"]
