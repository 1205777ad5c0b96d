"""Serving layer: cross-session micro-batched point reads and a
CDC-invalidated result cache (counterpart of citus_tpu/serving/).

* ``classify`` — the ONE parse-tree fast-path point-read classifier,
  shared by the WLM admission exemption and the serving path;
* ``batcher`` — a per-data_dir cross-session micro-batcher: point-index
  lookups from concurrent sessions coalesce into one batched
  stripe/chunk probe over the union of keys, demuxed back per session
  (single-flight when idle, so an unloaded system adds no latency);
* ``result_cache`` — a per-data_dir LRU of finished read-statement
  results keyed on (statement shape, bound params, catalog version,
  settings), invalidated by consuming the change journal per table —
  never by wall-clock TTLs — with a manifest-identity backstop.

Both serve from the host: a batched point read and a cache hit launch
no kernel.
"""

from .batcher import MicroBatcher, batcher_for
from .classify import PointRead, classify_point_read
from .result_cache import ResultCache, result_cache_for

__all__ = [
    "MicroBatcher", "PointRead", "ResultCache", "batcher_for",
    "classify_point_read", "result_cache_for",
]
