"""Configuration variable registry (the GUC analogue).

The reference registers 145 `citus.*` GUCs in one place
(Citus src/backend/distributed/shared_library_init.c:982,
RegisterCitusConfigVariables) with typed definitions, defaults, ranges, and
docstrings.  This module mirrors that shape: a central typed registry, a
session-scoped settings object, and `set`/`get`/`show_all` with validation.

This copy registers only the variables the port reads; each keeps the
JAX package's name, default and range, so a setting means the same in
both packages.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

from .errors import ConfigError


@dataclass(frozen=True)
class ConfigVar:
    name: str
    default: Any
    doc: str
    vartype: type = int
    min_value: Any = None
    max_value: Any = None
    choices: tuple | None = None
    validate: Callable[[Any], None] | None = None


_REGISTRY: dict[str, ConfigVar] = {}


def _register(var: ConfigVar) -> None:
    if var.name in _REGISTRY:
        raise ConfigError(f"duplicate config var {var.name}")
    _REGISTRY[var.name] = var


def registered_vars() -> dict[str, ConfigVar]:
    return dict(_REGISTRY)


_register(ConfigVar(
    "shard_count", 8,
    "Number of hash shards for new distributed tables "
    "(ref: citus.shard_count, shared_library_init.c:2616).",
    int, min_value=1, max_value=64000))
_register(ConfigVar(
    "shard_replication_factor", 1,
    "Placements per shard on distinct nodes; reads fail over to the next "
    "replica when a node is disabled/removed "
    "(ref: citus.shard_replication_factor, shared_library_init.c).",
    int, min_value=1, max_value=64))
_register(ConfigVar(
    "enable_repartition_joins", True,
    "Allow dual/single repartition (all_to_all) joins "
    "(ref: citus.enable_repartition_joins, shared_library_init.c:1609).",
    bool))
_register(ConfigVar(
    "compute_dtype", "float32",
    "Device accumulation dtype for SQL double precision: float32 (the "
    "GPU default) or float64 (exact; the CPU parity tests).",
    str, choices=("float32", "float64")))
_register(ConfigVar(
    "join_output_capacity_factor", 1.0,
    "Static join-output headroom over probe-side capacity.",
    float, min_value=0.1, max_value=64.0))
_register(ConfigVar(
    "agg_group_capacity_factor", 1.5,
    "Static aggregate-output headroom over the estimated group count.",
    float, min_value=1.0, max_value=64.0))
_register(ConfigVar(
    "join_probe_bucket_factor", 2.0,
    "Per-bucket probe-slot headroom over the uniform-hash expectation "
    "for bucketed fused lookups (ops.join.bucketed_unique_lookup). "
    "Skewed buckets overflow and regrow through the normal retry path; "
    "capacity feedback tightens converged sizes.",
    float, min_value=1.0, max_value=64.0))
_register(ConfigVar(
    "agg_bucket_capacity_factor", 2.0,
    "Per-bucket row-slot headroom over the uniform expectation for "
    "bucketed dense-grid aggregation (ops/groupby.py). Hot buckets "
    "overflow and regrow through the normal retry path; capacity "
    "feedback tightens converged sizes.",
    float, min_value=1.0, max_value=64.0))
_register(ConfigVar(
    "enable_capacity_feedback", True,
    "After a clean execution, shrink buffers whose recorded actual row "
    "counts sit far below the planner's estimate and recompile once "
    "(the adaptive-executor actual-size feedback, adaptive_executor.c:962"
    ", done the static-shape way).",
    bool))
_register(ConfigVar(
    "max_cached_plans", 256,
    "Plan-cache entries; a structurally repeated query reuses its "
    "PlanCompiler (ref: planner/local_plan_cache.c:1-60).",
    int, min_value=0, max_value=100_000))
_register(ConfigVar(
    "max_cached_feed_bytes", 4 << 30,
    "Device byte budget for resident table feeds reused across "
    "queries (ref: connection/pool reuse, executor/adaptive_executor.c:962).",
    int, min_value=0, max_value=1 << 40))
_register(ConfigVar(
    "max_plan_buffer_bytes", 32 << 30,
    "Ceiling on a plan's largest static device buffer; a plan over it "
    "is refused before it allocates. 0 disables the guard.",
    int, min_value=0, max_value=1 << 44))
_register(ConfigVar(
    "columnar_stripe_row_limit", 150_000,
    "Rows per stripe (ref default 150000, columnar/README.md:96-112).",
    int, min_value=1_000, max_value=10_000_000))
_register(ConfigVar(
    "columnar_chunk_group_row_limit", 10_000,
    "Rows per chunk group (ref default 10000).",
    int, min_value=128, max_value=1_000_000))
_register(ConfigVar(
    "columnar_compression", "zstd",
    "Per-chunk compression codec (ref: none/pglz/lz4/zstd; here "
    "none/zlib/zstd).", str, choices=("none", "zlib", "zstd")))
_register(ConfigVar(
    "columnar_compression_level", 3,
    "Codec level (ref: columnar.compression_level).",
    int, min_value=1, max_value=19))
_register(ConfigVar(
    "storage_verify_checksums", True,
    "Verify stripe chunk/footer CRC32s on every read; a mismatch raises "
    "CorruptStripe (ref: PostgreSQL data_checksums).",
    bool))


class Settings:
    """Session-scoped mutable settings over the global registry."""

    def __init__(self, overrides: dict[str, Any] | None = None):
        self._values: dict[str, Any] = {}
        # bumped on every mutation; consumers (the serving result
        # cache's key memo) cache derived fingerprints per version
        self.version = 0
        self._profile: tuple | None = None
        for name, value in (overrides or {}).items():
            self.set(name, value)

    def get(self, name: str) -> Any:
        if name in self._values:
            return self._values[name]
        var = _REGISTRY.get(name)
        if var is None:
            raise ConfigError(f"unrecognized configuration parameter {name!r}")
        return var.default

    def set(self, name: str, value: Any) -> None:
        var = _REGISTRY.get(name)
        if var is None:
            raise ConfigError(f"unrecognized configuration parameter {name!r}")
        if var.vartype is bool:
            if isinstance(value, str):
                lowered = value.strip().lower()
                if lowered in ("on", "true", "1", "yes"):
                    value = True
                elif lowered in ("off", "false", "0", "no"):
                    value = False
                else:
                    raise ConfigError(
                        f"{name}: invalid boolean value {value!r}")
            value = bool(value)
        elif var.vartype is int:
            value = int(value)
        elif var.vartype is float:
            value = float(value)
        elif var.vartype is str:
            value = str(value)
        if var.min_value is not None and value < var.min_value:
            raise ConfigError(f"{name}: {value} below minimum {var.min_value}")
        if var.max_value is not None and value > var.max_value:
            raise ConfigError(f"{name}: {value} above maximum {var.max_value}")
        if var.choices is not None and value not in var.choices:
            raise ConfigError(f"{name}: invalid value {value!r}; choose from {var.choices}")
        if var.validate is not None:
            var.validate(value)
        self._values[name] = value
        self.version += 1
        self._profile = None

    def reset(self, name: str) -> None:
        self._values.pop(name, None)
        self.version += 1
        self._profile = None

    def show_all(self) -> dict[str, Any]:
        return {name: self.get(name) for name in sorted(_REGISTRY)}

    def profile(self) -> tuple:
        """The full settings profile as a sorted, hashable tuple —
        cached per version so hot paths (the serving result-cache key
        covers every knob) don't re-enumerate the registry per call.

        The memo is stamped with the version read BEFORE enumerating:
        a SET racing a concurrent statement can install a stale tuple,
        but the stamp no longer matches and the next call recomputes —
        a plain `None` sentinel would let the stale tuple (and the
        result-cache keys built from it) persist until the next SET."""
        p = self._profile
        if p is None or p[0] != self.version:
            v = self.version
            p = (v, tuple(sorted(self.show_all().items())))
            self._profile = p
        return p[1]

    @contextlib.contextmanager
    def override(self, **kwargs):
        saved = dict(self._values)
        try:
            for k, v in kwargs.items():
                self.set(k, v)
            yield self
        finally:
            self._values = saved
            self.version += 1
            self._profile = None
