"""Cluster operations — counterpart of citus_tpu/operations/.  This
slice ports the health check and node promotion (health.py); the
rebalancer, shard split/transfer, cleanup, scrubber and restore points
come with ROADMAP queue A item 10."""
