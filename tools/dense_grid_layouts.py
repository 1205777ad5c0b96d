#!/usr/bin/env python3
"""Time the dense-grid sum's (K1's) grid layouts against each other on
Q1-shaped inputs on one NVIDIA GPU.

    python3 tools/dense_grid_layouts.py [--n 6001536]

Each variant is citus_tpu_torch/csrc/dense_grid_sum.cu with a few
constants or lines replaced (VARIANTS), built under its own library
name: the layout the launcher would pick, or one forced (per thread,
per warp, per block, global atomics), with warp pre-aggregation or with
every lane adding alone ("plain"), and with other load batches.  The
input is Q1's column call (a bool row mask and five float32 columns, A
= 6) over N rows, with the slots of:

- q1: total 12, 4 non-empty groups with TPC-H Q1's shares at SF1;
- hot{T}: total T, the same 4 shares on 4 slots spread over [0, T);
- uniform{T}: total T, slots drawn uniformly;

T = 16 and 293 are the largest totals at A = 6 that the launcher gives
per-thread and per-warp copies, 4095 the largest a dense aggregate
sends;

each with 1.5% of rows parked at slot == total (filtered out).  Every
variant is first held against a float64 index_add_ of the same inputs
(1e-4 of each column's largest sum; the count column exact: the
layout the launcher picks must pass, another's error is printed), then
timed in turns (every variant, then in reverse): device ms at cold L2 and the
share of the byte bound, (N·4 + N·1 + 5·N·4 + total·6·4) / 3.35 TB/s.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CSRC = os.path.join(REPO, "citus_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "layouts")

# replacements in dense_grid_sum.cu that force a layout or change a knob
THREAD_OFF = ("constexpr int kThreadGridBytes = 96 * 1024;",
              "constexpr int kThreadGridBytes = 0;")
WARP_OFF = ("constexpr int kWarpGridBytes = 55 * 1024;",
            "constexpr int kWarpGridBytes = 0;")
BLOCK_OFF = ("} else if (cells * 4 <= kMaxDynSmem) {",
             "} else if (false) {")
PLAIN = [("g[u] = warp_agg::group_of(end[u], s[u], lane);",
          "g[u] = warp_agg::Group{{0u, 0}, end[u]};"),
         ("carry[u] = end[u] && end[u - 1] && s[u] == s[u - 1];",
          "carry[u] = false;")]


VARIANTS = {
    "picked": [],
    "thread_b4": [("constexpr int kThreadBatch = 8;",
                   "constexpr int kThreadBatch = 4;")],
    "warp": [THREAD_OFF],
    "warp_b1": [THREAD_OFF, ("constexpr int kWarpBatch = 2;",
                             "constexpr int kWarpBatch = 1;")],
    "warp_b4": [THREAD_OFF, ("constexpr int kWarpBatch = 2;",
                             "constexpr int kWarpBatch = 4;")],
    "block": [THREAD_OFF, WARP_OFF],
    "block_plain": [THREAD_OFF, WARP_OFF] + PLAIN,
    "global": [THREAD_OFF, WARP_OFF, BLOCK_OFF],
    "global_plain": [THREAD_OFF, WARP_OFF, BLOCK_OFF] + PLAIN,
}

# case -> (total, distribution, variants timed)
CASES = {
    "q1": (12, "q1", list(VARIANTS)),
    # the largest grid of per-thread copies at A = 6 (96 cells)
    "hot16": (16, "hot", ["picked", "warp"]),
    "uniform16": (16, "uniform", ["picked", "warp"]),
    "hot64": (64, "hot", ["picked", "block", "block_plain", "global",
                          "global_plain"]),
    "uniform64": (64, "uniform", ["picked", "block", "block_plain",
                                  "global", "global_plain"]),
    "hot256": (256, "hot", ["picked", "block", "block_plain", "global",
                            "global_plain"]),
    "uniform256": (256, "uniform", ["picked", "block", "block_plain",
                                    "global", "global_plain"]),
    # the largest grid of per-warp copies at A = 6 (1758 cells)
    "hot293": (293, "hot", ["picked", "block", "block_plain"]),
    "uniform293": (293, "uniform", ["picked", "block", "block_plain"]),
    "hot4095": (4095, "hot", ["picked", "block_plain", "global",
                              "global_plain"]),
    "uniform4095": (4095, "uniform", ["picked", "block_plain", "global",
                                      "global_plain"]),
}

# TPC-H Q1's groups at SF1 (A-F, N-F, N-O, R-F), as shares of its rows
Q1_SHARES = [0.2466, 0.0064, 0.4935, 0.2535]
TRASH = 0.015


def build(hk) -> dict:
    with open(os.path.join(CSRC, "dense_grid_sum.cu")) as f:
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
             "-Xcompiler", "-fPIC", "-I", CSRC, "-o", path[:-3] + ".so",
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{out}")
        regs = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                if "registers" in ln]
        cs.log(f"built {name}: {regs}")
        fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).dense_grid_sum_launch
        v, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [v, ll, v, ll, ll, v, ll, v]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def slots(rng, n, total, dist):
    import numpy as np

    if dist == "uniform":
        s = rng.integers(0, total, n)
    else:
        hot = [0, 3, 6, 9] if dist == "q1" else \
            [i * total // 4 for i in range(4)]
        s = np.asarray(hot)[rng.choice(4, n, p=Q1_SHARES)]
    s[rng.random(n) < TRASH] = total
    return s.astype(np.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=6_001_536)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dense_grid_layouts: no CUDA device is visible",
              file=sys.stderr)
        return 2
    from citus_tpu_torch.ops import hopper_kernels as hk

    ident = cs.card_identity()
    cs.log(ident)
    fns = build(hk)
    rng = np.random.default_rng(0)
    n = args.n
    cols = [torch.from_numpy(rng.random(n) < 0.985).cuda()] + [
        torch.from_numpy(rng.uniform(1, 1e5, n).astype(np.float32)).cuda()
        for _ in range(5)]
    a = len(cols)
    desc = (ctypes.c_longlong * (3 * a))(*[
        x for c in cols
        for x in (c.data_ptr(), c.stride(0), hk._DENSE_DTYPES[c.dtype])])
    stack64 = torch.stack([c.double() for c in cols], dim=1)
    for case, (total, dist, names) in CASES.items():
        slot = torch.from_numpy(slots(rng, n, total, dist)).cuda()
        ref = torch.zeros(total + 1, a, dtype=torch.float64,
                          device="cuda").index_add_(0, slot.long(),
                                                    stack64)[:total]
        scale = ref.abs().amax(0) + 1.0
        bound = (n * 4 + n * 1 + 5 * n * 4 + total * a * 4) \
            / cs.HBM_BYTES_PER_S * 1e3

        def call(fn, slot=slot, total=total):
            out = torch.zeros(total, a, device="cuda")
            err = fn(slot.data_ptr(), n, ctypes.addressof(desc), a, total,
                     out.data_ptr(), a,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed (cudaError {err})")
            return out

        for name in names:
            got = call(fns[name]).double()
            err = float(((got - ref).abs() / scale).max())
            ok = err <= 1e-4 and torch.equal(got[:, 0], ref[:, 0])
            cs.log(f"check {case} {name}: {err!r} of the column scale "
                   f"from float64, counts exact "
                   f"{bool(torch.equal(got[:, 0], ref[:, 0]))} -> "
                   f"{'ok' if ok else 'outside 1e-4'}")
            if name == "picked" and not ok:
                raise AssertionError(f"{case}: the launcher's layout "
                                     "disagrees with float64")
        for name in names + names[::-1]:
            dev = cs.device_ms(lambda f=fns[name]: call(f),
                               match="dense_grid_sum")
            cs.log(f"layout {case} {name}: device {dev!r} ms at cold L2 "
                   f"({bound / dev:.1%} of the {bound!r} ms bound) "
                   f"({ident})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
