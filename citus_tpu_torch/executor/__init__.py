"""The port's executor (the JAX package's re-exports)."""

from .batch import Block, block_from_numpy, block_to_numpy, compact_to_numpy
from .runner import Executor, ResultSet

__all__ = ["Block", "block_from_numpy", "block_to_numpy",
           "compact_to_numpy", "Executor", "ResultSet"]
