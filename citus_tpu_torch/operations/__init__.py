"""Cluster operations — counterpart of citus_tpu/operations/: the
health check and node promotion (health.py), deferred cleanup
(cleanup.py), shard moves and repair (shard_transfer.py), shard split
and tenant isolation (shard_split.py), the greedy rebalancer
(rebalancer.py), the storage scrubber (scrubber.py) and restore points
(restore_point.py), with the rebalancer's mesh fitting
(rebalance_mesh, drain_device)."""
