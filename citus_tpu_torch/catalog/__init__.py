from .catalog import (
    Catalog,
    ColocationGroup,
    DistributionMethod,
    NodeMetadata,
    ReplicationModel,
    ShardPlacement,
    TableMetadata,
)
from .distribution import (
    HASH_TOKEN_COUNT,
    INT32_MAX,
    INT32_MIN,
    ShardInterval,
    fmix32,
    hash_token,
    shard_index_for_token,
    shard_index_for_values,
    shard_interval_bounds,
)

__all__ = [
    "Catalog", "ColocationGroup", "DistributionMethod", "NodeMetadata",
    "ReplicationModel", "ShardPlacement", "TableMetadata", "ShardInterval",
    "HASH_TOKEN_COUNT", "INT32_MAX", "INT32_MIN", "fmix32", "hash_token",
    "shard_index_for_token", "shard_index_for_values", "shard_interval_bounds",
]
