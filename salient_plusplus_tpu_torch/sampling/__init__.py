from .batch import BatchSpec, EdgeBlock, PaddedBatch
from .oracle import multilayer_sample_np, pad_sample
from .sampler import (
    FastPreSampler, FastSampler, FastSamplerConfig, SamplerStats, batch_seed,
    split_seeds,
)
from .shufflers import (
    DistributedShuffler, FederatedDistributedShuffler, Shuffler,
)

__all__ = [
    "BatchSpec", "PaddedBatch", "EdgeBlock",
    "FastPreSampler", "FastSampler", "FastSamplerConfig", "SamplerStats",
    "multilayer_sample_np", "pad_sample",
    "batch_seed", "split_seeds", "Shuffler", "DistributedShuffler",
    "FederatedDistributedShuffler",
]
