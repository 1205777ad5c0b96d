#!/usr/bin/env python3
"""Time the port's bit unpack (K4) and the kernels' host launch path
against an older checkout's on one NVIDIA GPU.

    python3 tools/compare_bit_unpack.py ROOT [--sf 1.0] [--calls 2000]

ROOT is a checkout of the repo (a `git archive` unpacked under a
gitignored directory) whose kernels take the signatures of this tree's
(`hopper_kernels.KERNELS`); its `ops/hopper_kernels.py` is loaded as a
module of its own and builds its sources into its own csrc/build/.
Steps:

1. generate TPC-H at --sf and load customer, orders, lineitem and
   lineitem_nullable as chip_smoke.py does; run the main path's four
   queries once, checked against numpy, recording each kernel's largest
   call;
2. K4 against K4 on the recorded plane: ROOT's wrapper and kernel, this
   tree's, and variants of this tree's source (VARIANTS: other unit
   counts in flight per thread, byte loads, and the source as it is,
   called as the variants are), each held exactly to the plain version,
   then timed in turns (ROOT, this, this, ROOT; the variants forward
   then in reverse): device ms at cold L2 against the byte bound, and
   call ms;
3. the launch path of one K4 call, ROOT's wrapper and this tree's, cut
   into its parts (`split`), each timed alone on the host clock over
   --calls calls after a warm-up, beside the whole wrapper call;
4. call ms (CUDA events, back-to-back calls) of all five wrappers on the
   recorded inputs, ROOT's and this tree's, in turns (ROOT, this, this,
   ROOT).

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CSRC = os.path.join(REPO, "citus_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "bit_unpack_variants")

# replacements in bit_unpack.cu
VARIANTS = {
    "as_is": [],  # this tree's source, built and called as the others
    "unroll1": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;")],
    "unroll2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "byte_loads": [("const bool pairs = (reinterpret_cast<uintptr_t>(usrc) "
                    "& 1u) == 0;", "const bool pairs = false;")],
}


def load_root_module(root):
    """ROOT's ops/hopper_kernels.py as a module of its own."""
    path = os.path.join(root, "citus_tpu_torch", "ops", "hopper_kernels.py")
    spec = importlib.util.spec_from_file_location("root_hopper_kernels",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(hk) -> dict:
    with open(os.path.join(CSRC, "bit_unpack.cu")) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [hk._nvcc(), "-Xptxas=-v", "-gencode",
             "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{out}")
        regs = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                if "registers" in ln]
        cs.log(f"built {name}: {regs}")
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).bit_unpack_launch
        v, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [v, ll, ll, ll, v, v]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def record_main_path(hk, sf):
    """Load SF `sf` and run the main path's queries (checked against
    numpy) with every wrapper recorded; returns the recorded calls."""
    import citus_tpu_torch as ct
    from citus_tpu_torch.ingest import tpch

    tmp = tempfile.mkdtemp(prefix="citus_port_k4_")
    try:
        data = tpch.generate_tables(sf, seed=0)
        sess = ct.connect(os.path.join(tmp, "data"))
        tpch.load_tables(sess, data,
                         tables={"customer", "orders", "lineitem"})
        li, orders, cust = data["lineitem"], data["orders"], data["customer"]
        cs.load_nullable(sess, li, tpch)
        runs = [(tpch.QUERIES["Q1"], cs.check_q1, cs.numpy_q1(li)),
                (tpch.QUERIES["Q3"], cs.check_q3,
                 cs.numpy_q3(cust, orders, li)),
                (cs.HIGH_CARD_SQL, cs.check_high_card,
                 cs.numpy_high_card(li)),
                (cs.NULLABLE_SQL, cs.check_nullable, cs.numpy_nullable(li))]
        recorders = {n: cs.Recorder(hk, n) for n in hk.KERNELS}
        for r in recorders.values():
            r.install()
        try:
            for sql, check, want in runs:
                check(sess.execute(sql), want)
        finally:
            for r in recorders.values():
                r.remove()
        del sess
        return {n: r.args for n, r in recorders.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def host_us(fn, calls: int) -> float:
    """Host microseconds per call of fn over `calls` calls after a
    warm-up (perf_counter; whatever fn enqueues is waited for after the
    clock stops)."""
    import torch

    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def compare_k4(hk, root_hk, fns, packed, cap, ident) -> None:
    import torch

    rows = packed.numel() // packed.shape[-1]
    w = packed.shape[-1]
    want = hk.bit_unpack_plain(packed, cap)

    def variant(fn):
        def call():
            out = torch.empty(want.shape, dtype=torch.bool, device="cuda")
            err = fn(packed.data_ptr(), rows, w, cap, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed (cudaError {err})")
            return out
        return call

    cases = {"root": lambda: root_hk.bit_unpack(packed, cap),
             "this": lambda: hk.bit_unpack(packed, cap)}
    cases.update({name: variant(fn) for name, fn in fns.items()})
    for name, fn in cases.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"K4 {name} disagrees with its plain "
                                 "version")
    bound = (packed.numel() + rows * cap) / cs.HBM_BYTES_PER_S * 1e3
    cs.log(f"K4 input: packed {tuple(packed.shape)}, cap {cap}; every "
           f"version exact against the plain one; bound {bound!r} ms")
    order = ["root", "this", "this", "root"] + list(fns) + list(fns)[::-1]
    for name in order:
        dev = cs.device_ms(cases[name], match="bit_unpack")
        cs.log(f"compare K4 {name}: device {dev!r} ms at cold L2 "
               f"({bound / dev:.1%} of the bound), call "
               f"{cs.time_ms(cases[name], reps=200)!r} ms ({ident})")


def split(hk, root_hk, packed, cap, calls, ident) -> None:
    """One K4 call's launch path, part by part, as each wrapper runs
    it."""
    import torch

    rows, w = 1, packed.shape[-1]
    out = torch.empty(cap, dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for label, m in (("root", root_hk), ("this", hk)):
        fn = m._fn("bit_unpack")
        argv = (packed.data_ptr(), rows, w, cap, out.data_ptr())
        parts = [
            ("checks (_on_cpu, _check)",
             lambda m=m: (m._on_cpu(packed),
                          m._check(packed, "packed", torch.uint8, 1))),
            ("torch.empty", lambda: torch.empty(
                *packed.shape[:-1], cap, dtype=torch.bool,
                device=packed.device)),
            ("Tensor.new_empty", lambda: packed.new_empty(
                packed.shape[:-1] + (cap,), dtype=torch.bool)),
            ("torch.cuda.current_stream().cuda_stream",
             lambda: torch.cuda.current_stream().cuda_stream),
            ("raw current stream", lambda: torch._C._cuda_getCurrentRawStream(
                torch._C._cuda_getDevice())),
            ("data_ptr and argument list", lambda: [
                a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
                for a in (packed, rows, w, cap, out)]),
            ("data_ptr only", lambda: (packed.data_ptr(), out.data_ptr())),
            ("entry point lookup (_fn)", lambda m=m: m._fn("bit_unpack")),
            ("ctypes call, no launch (rows 0)",
             lambda fn=fn: fn(argv[0], 0, w, cap, argv[4], stream)),
            ("ctypes call with the launch",
             lambda fn=fn, argv=argv: fn(*argv, stream)),
            ("the whole wrapper call",
             lambda m=m: m.bit_unpack(packed, cap)),
        ]
        for name, part in parts:
            cs.log(f"split {label}: {name}: {host_us(part, calls)!r} us per "
                   f"call ({ident})")
        cs.log(f"split {label}: call ms of the wrapper "
               f"{cs.time_ms(lambda m=m: m.bit_unpack(packed, cap), reps=200)!r}"
               f" ({ident})")


def call_ms_all(hk, root_hk, recorded, ident) -> None:
    for turn in ("root", "this", "this", "root"):
        m = root_hk if turn == "root" else hk
        for name in hk.KERNELS:
            args = recorded[name]
            ms = cs.time_ms(lambda m=m, name=name, args=args:
                            getattr(m, name)(*args), reps=200)
            cs.log(f"call_ms {turn} {name}: {ms!r} ms ({ident})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="the older checkout")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_bit_unpack: no CUDA device is visible",
              file=sys.stderr)
        return 2
    from citus_tpu_torch.ops import hopper_kernels as hk

    ident = cs.card_identity()
    cs.log(ident)
    hk.build_all()
    root_hk = load_root_module(args.root)
    root_hk.build_all()
    fns = build_variants(hk)
    recorded = record_main_path(hk, args.sf)
    packed, cap = recorded["bit_unpack"]
    compare_k4(hk, root_hk, fns, packed, cap, ident)
    split(hk, root_hk, packed, cap, args.calls, ident)
    call_ms_all(hk, root_hk, recorded, ident)
    return 0


if __name__ == "__main__":
    sys.exit(main())
