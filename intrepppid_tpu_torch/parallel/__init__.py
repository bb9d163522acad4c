"""Data parallelism (`intrepppid_tpu/parallel` counterpart): the process
group, its collectives, batch padding and serving's replicas."""
from intrepppid_tpu_torch.parallel.mesh import (
    all_reduce_max,
    all_reduce_sum_,
    barrier,
    broadcast_from_primary_int,
    broadcast_from_primary_str,
    check_data_parallel,
    gather_rows,
    initialize_distributed,
    is_initialized,
    pad_batch_to_multiple,
    pad_batch_to_size,
    process_count,
    process_index,
    replica_devices,
    replicate,
)

__all__ = [
    "all_reduce_max",
    "all_reduce_sum_",
    "barrier",
    "broadcast_from_primary_int",
    "broadcast_from_primary_str",
    "check_data_parallel",
    "gather_rows",
    "initialize_distributed",
    "is_initialized",
    "pad_batch_to_multiple",
    "pad_batch_to_size",
    "process_count",
    "process_index",
    "replica_devices",
    "replicate",
]
