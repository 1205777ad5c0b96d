"""Hand-written Hopper kernels for the aggregation and join-probe paths.

Counterpart of citus_tpu/ops/pallas_kernels.py.  Three of its five TPU
kernels sit on the port's main path and have a CUDA C++ twin here, each
in its own source under citus_tpu_torch/csrc/:

  dense_grid_sum         ← dense_grid_aggregate_pallas   (Q1's dense grid)
  bucketed_probe         ← bucketed_probe_pallas         (Q3's lookup)
  bucketed_groupby_sums  ← bucketed_groupby_sums_pallas  (high-card GROUP BY)

Each wrapper dispatches on the tensor's device and nothing else: a CPU
tensor takes the plain PyTorch version beside it (the CPU tests and the
parity anchor), a CUDA tensor launches the kernel or raises — there is no
fallback from a failed build or launch.  Every launch adds one to
LAUNCHES[name]; chip_smoke.py zeroes the counts before the main path and
reads them after, to show the path went through the kernels.

The sources build at first use with nvcc for sm_90a into plain C shared
libraries (one nvcc per source, started together), loaded with ctypes.
The build directory, csrc/build/, is not part of the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "build")

# kernel name → (source file, C entry point, C signature: p = pointer,
# l = long long; every entry point takes the stream last and returns
# cudaGetLastError() as int)
KERNELS = {
    "dense_grid_sum": ("dense_grid_sum.cu", "dense_grid_sum_launch",
                       "pplllp"),
    "bucketed_probe": ("bucketed_probe.cu", "bucketed_probe_launch",
                       "pplllp"),
    "bucketed_groupby_sums": ("bucketed_groupby_sums.cu",
                              "bucketed_groupby_sums_launch", "ppllllp"),
}
_CTYPE = {"p": ctypes.c_void_p, "l": ctypes.c_longlong}

# launches per kernel since the last reset (plain-version calls never
# count)
LAUNCHES = {name: 0 for name in KERNELS}

# shared-memory budget a block may opt into on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _so_path(src: str) -> str:
    with open(os.path.join(_CSRC, src), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"{os.path.splitext(src)[0]}-{digest}.so")


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel source not yet built (one nvcc process per
    source, all running at once) and load the libraries.  Returns the
    compiler output of each kernel built in this call (with `verbose`,
    ptxas's register and spill report).  Raises on any compiler
    failure."""
    with _lock:
        os.makedirs(_BUILD, exist_ok=True)
        procs = {}
        for name, (src, _entry, _sig) in KERNELS.items():
            if name in _libs:
                continue
            so = _so_path(src)
            if os.path.exists(so):
                continue
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-o", so + ".tmp", os.path.join(_CSRC, src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
        built = {}
        errors = []
        for name, (p, so) in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}: nvcc exit {p.returncode}\n{out}")
                continue
            os.replace(so + ".tmp", so)
            built[name] = out
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for name, (src, entry, sig) in KERNELS.items():
            if name not in _libs:
                lib = ctypes.CDLL(_so_path(src))
                fn = getattr(lib, entry)
                fn.argtypes = [_CTYPE[c] for c in sig] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _libs[name] = lib
        return built


def _fn(name: str):
    if name not in _libs:
        build_all()
    return getattr(_libs[name], KERNELS[name][1])


def _check(t: torch.Tensor, what: str, dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _launch(name: str, *args) -> None:
    """Launch on the current stream; the tensors in `args` stay
    referenced by the caller for the kernel's lifetime."""
    stream = torch.cuda.current_stream().cuda_stream
    argv = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
            for a in args]
    err = _fn(name)(*argv, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    LAUNCHES[name] += 1


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {devs}")


# -- K1: dense-grid segment sum ---------------------------------------------

def dense_grid_sum_plain(slot: torch.Tensor, values: torch.Tensor,
                         total: int) -> torch.Tensor:
    """sums[k, a] = Σ_{slot[i]=k} values[i, a] for k < total; rows whose
    slot is outside [0, total) are ignored.  One-hot × values for small
    grids (the JAX executor's formulation), index_add_ otherwise."""
    n, a = values.shape
    vals = values.to(torch.float32)
    keep = (slot >= 0) & (slot < total)
    s = torch.where(keep, slot.to(torch.int64),
                    torch.full_like(slot, total, dtype=torch.int64))
    if n * (total + 1) <= (1 << 26):
        ids = torch.arange(total + 1, device=slot.device)
        onehot = (s[:, None] == ids[None, :]).to(torch.float32)
        return (onehot.T @ vals)[:total]
    out = torch.zeros(total + 1, a, dtype=torch.float32,
                      device=values.device)
    return out.index_add_(0, s, vals)[:total]


def dense_grid_sum(slot: torch.Tensor, values: torch.Tensor,
                   total: int) -> torch.Tensor:
    """slot [N] int32, values [N, A] float32 → [total, A] float32.
    Kernel form of compiler._dense_segment_sum (replaces
    dense_grid_aggregate_pallas)."""
    if _on_cpu(slot, values):
        return dense_grid_sum_plain(slot, values, total)
    _check(slot, "slot", torch.int32, 1)
    _check(values, "values", torch.float32, 2)
    n, a = values.shape
    if slot.shape[0] != n:
        raise ValueError("slot and values disagree on N")
    out = torch.zeros(total, a, dtype=torch.float32, device=values.device)
    if n and total and a:
        _launch("dense_grid_sum", slot, values, n, a, total, out)
    return out


# -- K2: bucketed probe gather ----------------------------------------------

def bucketed_probe_plain(dir2d: torch.Tensor,
                         loc2d: torch.Tensor) -> torch.Tensor:
    """out[b, j] = dir2d[b, loc2d[b, j]]."""
    return torch.take_along_dim(dir2d, loc2d.to(torch.int64), dim=1)


def bucketed_probe(dir2d: torch.Tensor, loc2d: torch.Tensor) -> torch.Tensor:
    """dir2d [nb, tile] int32, loc2d [nb, cap] int32 (tile-local slots,
    garbage lanes clipped in range) → [nb, cap] int32 (replaces
    bucketed_probe_pallas)."""
    if _on_cpu(dir2d, loc2d):
        return bucketed_probe_plain(dir2d, loc2d)
    _check(dir2d, "dir2d", torch.int32, 2)
    _check(loc2d, "loc2d", torch.int32, 2)
    nb, tile = dir2d.shape
    if loc2d.shape[0] != nb:
        raise ValueError("dir2d and loc2d disagree on the bucket count")
    if tile * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"directory tile of {tile} slots exceeds shared "
                         "memory")
    cap = loc2d.shape[1]
    out = torch.empty(nb, cap, dtype=torch.int32, device=dir2d.device)
    if nb and cap:
        _launch("bucketed_probe", dir2d, loc2d, nb, tile, cap, out)
    return out


# -- K3: bucket-tiled group-by sums -----------------------------------------

def bucketed_groupby_sums_plain(loc2d: torch.Tensor, stack: torch.Tensor,
                                tile: int) -> torch.Tensor:
    """Per bucket b: out[b, k, :] = Σ_{loc2d[b, i]=k} stack[b, i, :]
    (one index_add_ over bucket-offset slots)."""
    nb, cap = loc2d.shape
    a = stack.shape[2]
    boff = torch.arange(nb, device=loc2d.device)[:, None] * tile
    flat = (loc2d.to(torch.int64) + boff).reshape(-1)
    out = torch.zeros(nb * tile, a, dtype=torch.float32,
                      device=stack.device)
    out.index_add_(0, flat, stack.reshape(nb * cap, a).to(torch.float32))
    return out.reshape(nb, tile, a)


def bucketed_groupby_sums(loc2d: torch.Tensor, stack: torch.Tensor,
                          tile: int) -> torch.Tensor:
    """loc2d [nb, cap] int32 tile-local slots (garbage lanes hold slot 0
    with zeroed values), stack [nb, cap, A] float32 → [nb, tile, A]
    float32 (replaces bucketed_groupby_sums_pallas).  Stacks wider than
    the shared-memory accumulator split by column, one launch each."""
    if _on_cpu(loc2d, stack):
        return bucketed_groupby_sums_plain(loc2d, stack, tile)
    _check(loc2d, "loc2d", torch.int32, 2)
    _check(stack, "stack", torch.float32, 3)
    nb, cap = loc2d.shape
    a = stack.shape[2]
    if stack.shape[:2] != (nb, cap):
        raise ValueError("loc2d and stack disagree on [nb, cap]")
    if tile * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"a tile of {tile} slots exceeds shared memory")
    out = torch.zeros(nb, tile, a, dtype=torch.float32, device=stack.device)
    if not (nb and cap and a):
        return out
    cols = max(1, MAX_SMEM_BYTES // (tile * 4))
    for c0 in range(0, a, cols):
        c1 = min(a, c0 + cols)
        part = stack if (c0, c1) == (0, a) else \
            stack[:, :, c0:c1].contiguous()
        dst = out if (c0, c1) == (0, a) else \
            torch.zeros(nb, tile, c1 - c0, dtype=torch.float32,
                        device=stack.device)
        _launch("bucketed_groupby_sums", loc2d, part, nb, cap, c1 - c0,
                tile, dst)
        if dst is not out:
            out[:, :, c0:c1] = dst
    return out
