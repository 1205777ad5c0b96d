"""Device pick and numeric guards for the PyTorch port.

Counterpart of citus_tpu/runtime.py.  Two contracts carry over:

* **int64 keys stay int64.**  Host/device hash parity and shard routing
  rely on 64-bit keys (ops.hashing folds them exactly like
  catalog.distribution.hash_token).  PyTorch keeps int64 tensors as
  int64 on every device, so no global switch is needed; the port simply
  never narrows a key unless the planner proved its range fits int32
  (JoinNode.key_int32), exactly like the JAX executor.
* **float32 sums are exact float32.**  The dense-grid sums
  (compiler._dense_sums) rely on exact f32 accumulation of int32 and
  bool counts while n < 2^24; TF32 would keep only ~10 mantissa bits,
  so it is pinned off for matmuls and cuDNN alike.

`resolve_device(None)` picks CUDA and raises when no GPU is visible:
the port never falls back to the CPU on its own.  The CPU is chosen
only when the caller asks for it (the tests do).
"""

from __future__ import annotations

import torch

from .errors import ConfigError


def configure_torch() -> None:
    """Idempotent numeric pins: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None → cuda:0, raising when no GPU is visible; otherwise the
    device the caller named."""
    configure_torch()
    if device is None:
        if not torch.cuda.is_available():
            raise ConfigError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port's plain formulations on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(f"device {device!r} requested but no CUDA "
                              "device is visible")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    elif dev.type != "cpu":
        raise ConfigError(f"unsupported device {device!r}")
    return dev
