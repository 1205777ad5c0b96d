"""Device mesh: N hash-sharded positions driven by one controller.

Counterpart of citus_tpu/distributed/mesh.py.  The JAX package builds a
jax.sharding.Mesh with one 'shards' axis and runs every statement as one
shard_map program over it.  Here a mesh is an ordered list of
*positions*, each with a stable id (the identity the MeshSim kill set and
the catalog's device-health ledger key on: positions renumber when the
mesh shrinks, ids never do) and a `torch.device`.  One thread — the
statement's — runs the per-position program for every position in
lockstep (executor/compiler.py), and the collectives below are the
points where each position hands its tensor to the mesh and gets back
its share.  Positions may share a card (the default: all N on the
session's device) or map onto several cards (`devices=`).

Collectives, on per-position lists of tensors:

* `all_to_all(mesh, parts)` — parts[i] is position i's [N, cap] pack by
  target (ops/partition.py); position j receives the [N, cap] block of
  every source's row j.  On one card this is a stack and a transpose;
  across cards, peer copies (`.to(dst, non_blocking=True)`), which the
  CUDA caching allocator orders on the current streams.
* `all_reduce(mesh, parts, op)` — sum / min / max, combined in position
  order (float sums are therefore deterministic for a given width).
* `all_gather(mesh, parts)` — the positions' tensors concatenated.

Fault surface: the seams are the per-position transfer
(``mesh.device_put``, here), the collective exchange and the result
fetch (``mesh.collective`` / ``mesh.fetch``, executor/compiler.py); the
armed MeshSim kills, hangs or errors chosen positions at them, so the
whole failover path runs on the CPU.  A CUDA error that matches the
device-loss signature is wrapped into DeviceLostError
(`_reraise_if_device_loss`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import DeviceLostError, ExecutionError
from ..utils.faultinjection import fault_point, mesh_device_check

# substrings CUDA puts in errors that mean "the device (or its context)
# is gone", as opposed to a launch bug or an allocator OOM: the
# DeviceLostError classification key
_DEVICE_LOSS_TOKENS = (
    "an illegal memory access",
    "unspecified launch failure",
    "uncorrectable ECC error",
    "GPU is lost",
    "cudaErrorDevicesUnavailable",
)


def is_device_loss(exc: BaseException) -> bool:
    """Does this backend exception report a lost or failed device
    (rather than a semantic error or an allocator OOM)?"""
    msg = str(exc)
    return any(tok in msg for tok in _DEVICE_LOSS_TOKENS)


@dataclass(frozen=True)
class Mesh:
    """Ordered positions: `ids[i]` is position i's stable id and
    `devices[i]` the torch device it runs on."""

    ids: tuple
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.ids)

    def single_device(self) -> bool:
        """Do all positions share one device?"""
        return len(set(self.devices)) <= 1


def make_mesh(n_devices: int | None = None, devices=None,
              ids=None, default_device="cpu") -> Mesh:
    """Build the mesh.  `devices` lists one device per position (a
    device may repeat: positions then share it); without it every
    position lives on `default_device`.  `n_devices` above what
    `devices` provides raises, as the JAX package's make_mesh does.
    `ids` (default 0..n-1) are the positions' stable ids — the
    degrade path rebuilds a shrunken mesh from the survivors' ids."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("cannot build a mesh over zero devices")
        n = n_devices or len(devs)
        if n > len(devs):
            raise ValueError(
                f"requested {n} devices, only {len(devs)} available")
        devs = devs[:n]
    else:
        n = n_devices or 1
        if n < 1:
            raise ValueError("cannot build a mesh over zero devices")
        devs = [torch.device(default_device)] * n
    ids = tuple(range(n)) if ids is None else tuple(ids)
    if len(ids) != len(devs):
        raise ValueError("one id per position")
    return Mesh(ids, tuple(devs))


def mesh_device_ids(mesh: Mesh) -> list[int]:
    """The positions' ids in position order."""
    return list(mesh.ids)


def mesh_without(mesh: Mesh, dead_ids) -> Mesh | None:
    """The survivors' mesh after losing `dead_ids`, or None when no
    position survives (total mesh loss)."""
    dead = set(dead_ids)
    keep = [(i, d) for i, d in zip(mesh.ids, mesh.devices)
            if i not in dead]
    if not keep:
        return None
    return Mesh(tuple(i for i, _ in keep), tuple(d for _, d in keep))


def probe_mesh_devices(mesh: Mesh) -> list[int]:
    """Health-probe every position with a one-scalar transfer and return
    the ids that failed: the detection pass for an opaque collective
    failure (DeviceLostError with device_id=None)."""
    dead: list[int] = []
    one = torch.zeros(1, dtype=torch.int32)
    for pid, dev in zip(mesh.ids, mesh.devices):
        try:
            mesh_device_check("mesh.device_put", (pid,))
            one.to(dev)
        except Exception:  # any failure of the probe marks the position lost
            dead.append(pid)
    return dead


def _host(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr))


def put_sharded(mesh: Mesh, arr) -> list[torch.Tensor]:
    """[n_pos, ...] host array → one tensor per position, on its device."""
    fault_point("mesh.device_put")
    mesh_device_check("mesh.device_put", mesh_device_ids(mesh))
    t = _host(arr)
    if t.shape[0] != mesh.size:
        raise ValueError(
            f"need one row per position: {t.shape[0]} != {mesh.size}")
    out = []
    for i, (pid, dev) in enumerate(zip(mesh.ids, mesh.devices)):
        try:
            out.append(t[i].to(dev))
        except Exception as e:
            _reraise_if_device_loss(e, "mesh.device_put", pid)
            raise
    return out


def put_sharded_slices(mesh: Mesh, slices) -> list[torch.Tensor]:
    """Per-position host slices → one tensor per position on its device
    (the device-owned feed path).  Every slice must share slices[0]'s
    shape: the positions run one program at one capacity."""
    if len(slices) != mesh.size:
        raise ValueError(
            f"need one slice per device: {len(slices)} != {mesh.size}")
    want = tuple(slices[0].shape)
    for i, s in enumerate(slices):
        if tuple(s.shape) != want:
            raise ExecutionError(
                f"put_sharded_slices: slice {i} has shape "
                f"{tuple(s.shape)}, expected {want} (all per-device "
                "slices must be padded to one capacity)")
    fault_point("mesh.device_put")
    out = []
    for s, pid, dev in zip(slices, mesh.ids, mesh.devices):
        # per-position seam: the moment a dying position refuses its slice
        mesh_device_check("mesh.device_put", (pid,))
        t = _host(s)
        try:
            out.append(t.to(dev, non_blocking=t.is_pinned()))
        except Exception as e:
            _reraise_if_device_loss(e, "mesh.device_put", pid)
            raise
    return out


def put_replicated(mesh: Mesh, arr) -> list[torch.Tensor]:
    """One host array → the same values on every position (one tensor
    per distinct device, shared by the positions on it)."""
    fault_point("mesh.device_put")
    mesh_device_check("mesh.device_put", mesh_device_ids(mesh))
    t = _host(arr)
    per_dev: dict = {}
    out = []
    for pid, dev in zip(mesh.ids, mesh.devices):
        if dev not in per_dev:
            try:
                per_dev[dev] = t.to(dev)
            except Exception as e:
                _reraise_if_device_loss(e, "mesh.device_put", pid)
                raise
        out.append(per_dev[dev])
    return out


def _reraise_if_device_loss(e: BaseException, seam: str,
                            device_id: int | None = None) -> None:
    """Wrap a backend error matching the device-loss signature into the
    classified DeviceLostError (no-op otherwise: the caller re-raises)."""
    if isinstance(e, DeviceLostError):
        raise e
    if is_device_loss(e):
        raise DeviceLostError(
            f"device loss at {seam!r}: {e}", device_id=device_id,
            seam=seam) from e


# ---------------------------------------------------------------------------
# collectives (one controller: every position's tensor in one list)

def _on(t: torch.Tensor, dev) -> torch.Tensor:
    return t if t.device == dev else t.to(dev, non_blocking=True)


def all_to_all(devices, parts: list) -> list:
    """parts[i]: position i's [N, cap, ...] pack by target → position j
    gets the [N, cap, ...] stack of every source's row j (source-major,
    the order `jax.lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)` delivers)."""
    n = len(parts)
    if n == 1:
        return [parts[0]]
    if len(set(devices)) <= 1:
        # one card: [src, dst, ...] → [dst, src, ...]
        ex = torch.stack(parts).transpose(0, 1)
        return [ex[j] for j in range(n)]
    return [torch.stack([_on(parts[i][j], devices[j]) for i in range(n)])
            for j in range(n)]


def all_reduce(devices, parts: list, op: str) -> list:
    """sum / min / max over the positions' tensors (position order);
    every position gets the result on its own device."""
    n = len(parts)
    if n == 1:
        return [parts[0]]
    dev0 = devices[0]
    acc = _on(parts[0], dev0)
    for t in parts[1:]:
        t = _on(t, dev0)
        if op == "sum":
            acc = acc + t
        elif op == "min":
            acc = torch.minimum(acc, t)
        elif op == "max":
            acc = torch.maximum(acc, t)
        else:
            raise ExecutionError(f"bad all_reduce op {op!r}")
    return [_on(acc, d) for d in devices]


def all_gather(devices, parts: list) -> list:
    """The positions' tensors concatenated on axis 0, on every position."""
    if len(parts) == 1:
        return [parts[0]]
    dev0 = devices[0]
    cat = torch.cat([_on(t, dev0) for t in parts])
    return [_on(cat, d) for d in devices]
