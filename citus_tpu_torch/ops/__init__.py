from .aggregate import distinct, segment_aggregate
from .groupby import (
    bucketed_grid_aggregate,
    group_bucket_count,
    group_bucket_eligible,
)
from .hashing import hash_token, shard_index_from_token, tile_buckets
from .join import (
    bucketed_unique_lookup,
    dense_unique_lookup,
    expand_join,
    expand_join_outer,
    expand_join_pairs,
    lookup_join,
    lower_bound,
    match_counts,
    sort_build_side,
)
from .partition import pack_by_target

__all__ = [
    "distinct", "segment_aggregate",
    "bucketed_grid_aggregate", "group_bucket_count",
    "group_bucket_eligible",
    "hash_token", "shard_index_from_token", "tile_buckets",
    "bucketed_unique_lookup", "dense_unique_lookup",
    "expand_join", "expand_join_outer", "expand_join_pairs", "lookup_join",
    "lower_bound",
    "match_counts", "sort_build_side", "pack_by_target",
]
