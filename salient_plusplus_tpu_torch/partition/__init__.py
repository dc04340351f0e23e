from .partitioner import (
    multiconstraint_partition, random_partition, contiguous_partition,
    get_4d_node_weights, partition_quality,
)

__all__ = [
    "multiconstraint_partition", "random_partition", "contiguous_partition",
    "get_4d_node_weights", "partition_quality",
]
