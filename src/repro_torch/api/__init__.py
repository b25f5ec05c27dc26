"""The query plane: address spaces → DecodePlan → executors.

Typed addresses (`ReadId`, `ByteRange`, `Region`/`parse_region`), a
`QueryPlanner` that lowers any batch to one `DecodePlan`, the executors
(`DeviceExecutor`, `StreamingExecutor`), the device-resident
`BlockCache`, the `GenomicArchive` facade, and the training data plane's
`ArchiveDataset` with its samplers.
"""
from repro_torch.api.address import (Address, ByteRange, NameTable, ReadId,
                                     Region, normalize, parse_region)
from repro_torch.api.archive import GenomicArchive
from repro_torch.api.dataset import (ArchiveDataset, SequentialSampler,
                                     UniformSampler, make_sampler)
from repro_torch.api.cache import (BlockCache, EvictionPolicy,
                                   FrequencyPolicy, FrequencySketch,
                                   LRUPolicy, PinRangePolicy, TinyLFUPolicy)
from repro_torch.api.executors import (ChunkStats, DeviceExecutor,
                                       ShardedExecutor, StreamingExecutor)
from repro_torch.api.plan import (CachePlan, DecodePlan, QueryPlanner,
                                  anchor_floor, anchor_window_groups,
                                  covering_blocks)

__all__ = [
    "Address", "ArchiveDataset", "BlockCache", "ByteRange", "CachePlan",
    "ChunkStats", "DecodePlan", "DeviceExecutor", "EvictionPolicy",
    "FrequencyPolicy", "FrequencySketch", "GenomicArchive", "LRUPolicy",
    "NameTable", "PinRangePolicy", "QueryPlanner", "ReadId", "Region",
    "SequentialSampler", "ShardedExecutor", "StreamingExecutor",
    "TinyLFUPolicy", "UniformSampler", "anchor_floor",
    "anchor_window_groups", "covering_blocks", "make_sampler", "normalize",
    "parse_region",
]
