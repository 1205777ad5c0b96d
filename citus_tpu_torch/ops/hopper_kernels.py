"""Hand-written Hopper kernels for the aggregation and join-probe paths.

Counterpart of citus_tpu/ops/pallas_kernels.py.  Each of its five TPU
kernels has a CUDA C++ twin here, in its own source under
citus_tpu_torch/csrc/:

  dense_grid_sum         ← dense_grid_aggregate_pallas   (Q1's dense grid)
  bucketed_probe         ← bucketed_probe_pallas         (Q3's lookup)
  bucketed_groupby_sums  ← bucketed_groupby_sums_pallas  (high-card GROUP BY)
  bit_unpack             ← bit_unpack_pallas    (null planes, device scans)
  dict_decode            ← dict_decode_pallas   (low-NDV floats, device scans)

Each wrapper dispatches on the tensor's device and nothing else: a CPU
tensor takes the plain PyTorch version beside it (the CPU tests and the
parity anchor), a CUDA tensor launches the kernel or raises — there is no
fallback from a failed build or launch.  Every launch adds one to
LAUNCHES[name]; chip_smoke.py zeroes the counts before the main path and
reads them after, to show the path went through the kernels.  A launch
made while a CUDA graph is captured (executor/graphs.py) runs nothing
then: `recording_launches` collects it on the graph instead, and every
replay of the graph adds those launches to LAUNCHES (`count_replay`).

The sources build at first use with nvcc for sm_90a into plain C shared
libraries (one nvcc per source, started together), loaded with ctypes.
The build directory, csrc/build/, is not part of the checkout.
"""

from __future__ import annotations

import contextlib
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
                       "plpllpl"),
    "bucketed_probe": ("bucketed_probe.cu", "bucketed_probe_launch",
                       "pplllp"),
    "bucketed_groupby_sums": ("bucketed_groupby_sums.cu",
                              "bucketed_groupby_sums_launch", "pplllllp"),
    "bit_unpack": ("bit_unpack.cu", "bit_unpack_launch", "plllp"),
    "dict_decode": ("dict_decode.cu", "dict_decode_launch", "plpllllp"),
}
_CTYPE = {"p": ctypes.c_void_p, "l": ctypes.c_longlong}

# launches per kernel since the last reset (plain-version calls never
# count)
LAUNCHES = {name: 0 for name in KERNELS}

# shared-memory budget a block may opt into on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448

_lock = threading.Lock()
# kernel name → its C entry point, argtypes set: bound once, called as is
_entries: dict[str, ctypes._CFuncPtr] = {}
# LAUNCHES is read-modify-written by every session thread that launches
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# per thread: the launches of a CUDA graph being captured, or None
_capture_tls = threading.local()


def count_launch(name: str) -> None:
    """One launch of kernel `name`, counted exactly under concurrent
    sessions (`+=` on a dict entry is not atomic across threads).  Under
    `recording_launches` it is recorded for the graph instead."""
    rec = getattr(_capture_tls, "rec", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


def count_replay(launches: dict[str, int]) -> None:
    """One replay of a captured graph: its recorded launches ran."""
    with _count_lock:
        for name, n in launches.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def recording_launches():
    """Inside the block this thread's launches are recorded into the
    yielded dict, not counted: a capture enqueues nothing that runs."""
    rec: dict[str, int] = {}
    _capture_tls.rec = rec
    try:
        yield rec
    finally:
        _capture_tls.rec = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _so_path(src: str) -> str:
    """The library's path, named by a digest of its source and of the
    shared headers (csrc/*.cuh) it may include."""
    digest = hashlib.sha1()
    for name in [src] + sorted(f for f in os.listdir(_CSRC)
                               if f.endswith(".cuh")):
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:12]
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
            if name in _entries:
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
            if name not in _entries:
                fn = getattr(ctypes.CDLL(_so_path(src)), entry)
                fn.argtypes = [_CTYPE[c] for c in sig] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _entries[name] = fn
        return built


def _fn(name: str):
    fn = _entries.get(name)
    if fn is None:
        build_all()
        fn = _entries[name]
    return fn


def _check(t: torch.Tensor, what: str, dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _launch(name: str, *args) -> None:
    """Launch on the current device's current stream.  `args` are the
    entry point's arguments before the stream, tensors as their
    data_ptr(); the caller keeps the tensors referenced for the
    kernel's lifetime."""
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")
    count_launch(name)


def _on_cpu(*tensors) -> bool:
    on_cuda = sum(t.is_cuda for t in tensors)
    if on_cuda == len(tensors):
        return False
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {devs}")


# -- K1: dense-grid segment sum ---------------------------------------------

# columns per launch (the kernel's by-value column table); more take more
# launches
DENSE_MAX_COLS = 16
_DENSE_DTYPES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}


def _dense_columns(values) -> list[torch.Tensor]:
    """An [N, A] tensor or a sequence of A [N] columns → the A columns
    (a stack's columns are views of stride A)."""
    if isinstance(values, torch.Tensor):
        if values.dim() != 2:
            raise ValueError(f"values: expected [N, A], got {values.dim()} "
                             "dims")
        return list(values.unbind(1))
    return list(values)


def dense_grid_sum_plain(slot: torch.Tensor, values,
                         total: int) -> torch.Tensor:
    """sums[k, j] = Σ_{slot[i]=k} column j at row i for k < total; rows
    whose slot is outside [0, total) are ignored.  The columns stacked
    as float32, then one-hot × values for small grids (the JAX
    executor's formulation), else index_add_ accumulating in float64
    and rounded to float32: a float32 scatter adds each slot's rows one
    after another, and over millions of rows (Q1's groups at SF1) it
    drifts past 1e-4 of the sum."""
    vals = values.to(torch.float32) if isinstance(values, torch.Tensor) \
        else torch.stack([c.to(torch.float32) for c in values], dim=1)
    n, a = vals.shape
    keep = (slot >= 0) & (slot < total)
    s = torch.where(keep, slot.to(torch.int64),
                    torch.full_like(slot, total, dtype=torch.int64))
    # an ignored row's value (inf or NaN under a filter) must not reach
    # the product
    vals = torch.where(keep[:, None], vals,
                       torch.zeros((), device=vals.device))
    if n * (total + 1) <= (1 << 26):
        ids = torch.arange(total + 1, device=slot.device)
        onehot = (s[:, None] == ids[None, :]).to(torch.float32)
        return (onehot.T @ vals)[:total]
    out = torch.zeros(total + 1, a, dtype=torch.float64, device=vals.device)
    return out.index_add_(0, s, vals.double())[:total].float()


def dense_grid_sum(slot: torch.Tensor, values, total: int) -> torch.Tensor:
    """slot [N] int32; values an [N, A] tensor or a sequence of A columns
    [N], each float32, int32 or bool, at any element stride → [total, A]
    float32.  The kernel reads each column where it lies and converts in
    registers; one launch per DENSE_MAX_COLS columns.  Kernel form of
    the dense aggregate's per-slot sums (replaces
    dense_grid_aggregate_pallas)."""
    cols = _dense_columns(values)
    if _on_cpu(slot, *cols):
        return dense_grid_sum_plain(slot, values, total)
    _check(slot, "slot", torch.int32, 1)
    n = slot.shape[0]
    for j, c in enumerate(cols):
        if c.dtype not in _DENSE_DTYPES:
            raise TypeError(f"column {j}: expected float32, int32 or bool, "
                            f"got {c.dtype}")
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"column {j}: expected shape [{n}], got "
                             f"{tuple(c.shape)}")
    a = len(cols)
    out = torch.zeros(total, a, dtype=torch.float32, device=slot.device)
    if not (n and total and a):
        return out
    for c0 in range(0, a, DENSE_MAX_COLS):
        part = cols[c0:c0 + DENSE_MAX_COLS]
        desc = (ctypes.c_longlong * (3 * len(part)))(*[
            x for c in part
            for x in (c.data_ptr(), c.stride(0), _DENSE_DTYPES[c.dtype])])
        _launch("dense_grid_sum", slot.data_ptr(), n,
                ctypes.addressof(desc), len(part), total,
                out.data_ptr() + 4 * c0, a)
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
        _launch("bucketed_probe", dir2d.data_ptr(), loc2d.data_ptr(), nb,
                tile, cap, out.data_ptr())
    return out


# -- K3: bucket-tiled group-by sums -----------------------------------------

# lanes a block of the group-by sums takes at least when buckets split
GROUPBY_MIN_SPLIT_ROWS = 1024

_SMS: dict[int, int] = {}  # SM count per device index


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def groupby_split_rows(nb: int, cap: int, sms: int) -> int:
    """Lanes per block of the group-by sums (a multiple of 4): buckets
    split into row ranges until about 2 blocks per SM run, but no range
    is shorter than GROUPBY_MIN_SPLIT_ROWS.  A result >= cap gives every
    bucket one block, which owns its output tile."""
    splits = max(1, -(-2 * sms // max(nb, 1)))
    rows = max(-(-cap // splits), GROUPBY_MIN_SPLIT_ROWS)
    return -(-rows // 4) * 4


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
    float32 (replaces bucketed_groupby_sums_pallas).  Lanes whose values
    are all ±0 add nothing and are skipped.  Stacks wider than the
    shared-memory accumulator split by column, one launch each."""
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
    if not (nb and cap and a):
        return torch.zeros(nb, tile, a, dtype=torch.float32,
                           device=stack.device)
    rows = groupby_split_rows(nb, cap, _sm_count(stack.device))
    # one block per bucket writes every cell of its tile; split buckets
    # add into a zeroed output
    alloc = torch.empty if rows >= cap else torch.zeros
    out = alloc(nb, tile, a, dtype=torch.float32, device=stack.device)
    cols = max(1, MAX_SMEM_BYTES // (tile * 4))
    for c0 in range(0, a, cols):
        c1 = min(a, c0 + cols)
        whole = (c0, c1) == (0, a)
        part = stack if whole else stack[:, :, c0:c1].contiguous()
        dst = out if whole else alloc(nb, tile, c1 - c0,
                                      dtype=torch.float32,
                                      device=stack.device)
        _launch("bucketed_groupby_sums", loc2d.data_ptr(), part.data_ptr(),
                nb, cap, c1 - c0, tile, rows, dst.data_ptr())
        if not whole:
            out[:, :, c0:c1] = dst
    return out


# -- K4: validity-plane bit unpack ------------------------------------------

def bit_unpack_plain(packed: torch.Tensor, cap: int) -> torch.Tensor:
    """Bit 7 - (i % 8) of byte i // 8 (numpy packbits order) for i < cap."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :cap].bool()


def bit_unpack(packed: torch.Tensor, cap: int) -> torch.Tensor:
    """packed [w] or [rows, w] uint8 (np.packbits along the last axis)
    → [cap] or [rows, cap] bool, cap ≤ 8·w (replaces bit_unpack_pallas)."""
    if _on_cpu(packed):
        return bit_unpack_plain(packed, cap)
    ndim = packed.dim()
    _check(packed, "packed", torch.uint8, ndim)
    if ndim not in (1, 2):
        raise ValueError(f"packed: expected 1 or 2 dims, got {ndim}")
    shape = packed.shape
    w = shape[-1]
    if not 0 <= cap <= 8 * w:
        raise ValueError(f"cap {cap} outside [0, 8·{w}]")
    rows = shape[0] if ndim == 2 else 1
    out = torch.empty(*shape[:-1], cap, dtype=torch.bool,
                      device=packed.device)
    if rows and w and cap:
        _launch("bit_unpack", packed.data_ptr(), rows, w, cap,
                out.data_ptr())
    return out


# -- K5: dictionary decode --------------------------------------------------

def dict_decode_plain(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """out[...] = lut[codes[...]]."""
    return lut[codes.to(torch.int64)]


def dict_decode(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes (any shape) uint8 or uint16, lut [nv] float32 or float64 →
    codes' shape in lut's dtype (replaces dict_decode_pallas).  The
    table is staged in shared memory when it fits, else read through
    the read-only cache.  Codes are not range-checked."""
    if _on_cpu(codes, lut):
        return dict_decode_plain(codes, lut)
    if codes.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"codes: expected uint8 or uint16, got {codes.dtype}")
    _check(codes, "codes", codes.dtype, codes.dim())
    if lut.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"lut: expected float32 or float64, got {lut.dtype}")
    _check(lut, "lut", lut.dtype, 1)
    out = torch.empty(codes.shape, dtype=lut.dtype, device=codes.device)
    n = codes.numel()
    if n:
        lut_bytes = lut.numel() * lut.element_size()
        _launch("dict_decode", codes.data_ptr(), n, codes.element_size(),
                lut.data_ptr(), lut.numel(), lut.element_size(),
                int(lut_bytes <= MAX_SMEM_BYTES), out.data_ptr())
    return out
