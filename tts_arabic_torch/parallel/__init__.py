"""Parallelism over `torch.distributed`: meshes of named axes over the
ranks, the sharding policy, data parallelism (`data_parallel_jit`,
`Trainer(mesh=)`, `FastPitch2Wave(mesh=)`), sequence-parallel vocoding
and tensor-parallel FastPitch inference (the port's counterpart of the
JAX package's `parallel/`)."""
from .mesh import (DATA_AXIS, SEQ_AXIS, Mesh, all_gather, all_reduce,
                   all_reduce_grads, all_reduce_sum, batch_sharded,
                   data_parallel_jit, global_total, init_multiprocess,
                   local_batch_size, make_mesh, make_mesh_2d,
                   make_multiprocess_mesh, mesh_context,
                   pad_batch_to_devices, process_local_rows, replicate,
                   replicated, shard_batch, shard_batch_from_process_local,
                   torchrun_mesh)
from .sp import sp_vocode
from .tp import (MODEL_AXIS, fastpitch_tp_shardings, make_mesh_dp_tp,
                 tp_mel_infer_jit)

__all__ = [
    "DATA_AXIS", "SEQ_AXIS", "MODEL_AXIS", "Mesh", "make_mesh_2d",
    "batch_sharded", "data_parallel_jit", "init_multiprocess",
    "local_batch_size", "make_mesh", "make_mesh_dp_tp",
    "make_multiprocess_mesh",
    "mesh_context", "pad_batch_to_devices", "process_local_rows",
    "replicate", "replicated", "shard_batch",
    "shard_batch_from_process_local", "sp_vocode",
    "fastpitch_tp_shardings", "tp_mel_infer_jit",
    "all_gather", "all_reduce", "all_reduce_grads", "all_reduce_sum",
    "global_total", "torchrun_mesh",
]
