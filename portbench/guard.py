"""What may not be loaded in a benchmark process: JAX and the JAX
package `citus_tpu`.  Names are compared by their top-level part, whole:
`citus_tpu_torch` (the port) is not `citus_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "citus_tpu")


def forbidden_loaded(names=None) -> list[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})
