"""The port's device mesh (counterpart of citus_tpu/distributed)."""
