"""Coordinated transactions: the hybrid logical clock, shard locks with
deadlock detection, and the 2PC commit log with its recovery."""
