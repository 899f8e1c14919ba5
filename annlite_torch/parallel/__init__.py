from .sharded_index import (
    ShardedFlatIndex,
    ShardedGraphIndex,
    ShardedIVFPQIndex,
    ShardedPQIndex,
)
from .mesh import (
    SHARD_AXIS,
    make_mesh,
    replicate,
    shard_codes,
    shard_mask,
    shard_rows,
    sharded_adc_topk,
    sharded_beam_topk,
    sharded_ivf_topk,
    sharded_lloyd_step,
    sharded_scan_topk,
)

__all__ = [
    'ShardedFlatIndex',
    'ShardedGraphIndex',
    'ShardedIVFPQIndex',
    'ShardedPQIndex',
    'SHARD_AXIS',
    'make_mesh',
    'replicate',
    'shard_codes',
    'shard_mask',
    'shard_rows',
    'sharded_adc_topk',
    'sharded_beam_topk',
    'sharded_ivf_topk',
    'sharded_lloyd_step',
    'sharded_scan_topk',
]
