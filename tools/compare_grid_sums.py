#!/usr/bin/env python3
"""Time the port's dense-grid sum (K1) and bucketed group-by sums (K3),
and its Q1 and nullable-aggregate warm runs, against an older checkout's
on one NVIDIA GPU.

    python3 tools/compare_grid_sums.py ROOT [--sf 1.0] [--reps 3]

ROOT is a checkout of the repo (a `git archive` unpacked under a
gitignored directory) whose kernels take a [N, A] float32 stack: its K1
entry is dense_grid_sum_launch(slot, values, n, a, total, out, stream)
and its K3 entry bucketed_groupby_sums_launch(loc2d, stack, nb, cap, a,
tile, out, stream) into a zeroed output, the sources before K1's column
form.  Steps:

1. generate TPC-H lineitem at --sf and load it, and lineitem_nullable,
   as chip_smoke.py does; run Q1 and the high-cardinality GROUP BY once,
   checked against numpy, recording K1's and K3's largest calls;
2. kernel against kernel: ROOT's two sources, built under other library
   names, and this tree's on the recorded inputs (K1 also on the
   columns stacked as ROOT's form needs them), in turns (ROOT, this,
   this, ROOT): device ms at cold L2, share of the bound, call ms; then
   index_add_ on the same inputs;
3. query against query: Q1 and the nullable aggregate warm and profiled
   through ROOT's package and this tree's on the same data_dir, one
   process each, in turns (ROOT, this, this, ROOT).

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def build_other(hk, root, name) -> str:
    """Build `root`'s source of kernel `name` under another library name
    (the nvcc flags of hopper_kernels.build_all)."""
    src = os.path.join(root, "citus_tpu_torch", "csrc", f"{name}.cu")
    out = os.path.join(root, "citus_tpu_torch", "csrc", "build",
                       f"{name}-other.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([hk._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", out, src], check=True, capture_output=True,
                   timeout=600)
    return out


def compare_kernels(hk, root, recorded, ident) -> None:
    import torch

    v, ll = ctypes.c_void_p, ctypes.c_longlong
    k1 = ctypes.CDLL(build_other(hk, root, "dense_grid_sum"))
    k1 = k1.dense_grid_sum_launch
    k1.argtypes, k1.restype = [v, v, ll, ll, ll, v, v], ctypes.c_int
    k3 = ctypes.CDLL(build_other(hk, root, "bucketed_groupby_sums"))
    k3 = k3.bucketed_groupby_sums_launch
    k3.argtypes, k3.restype = [v, v, ll, ll, ll, ll, v, v], ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    slot, values, total = recorded["dense_grid_sum"]
    cols = list(values.unbind(1)) if hasattr(values, "unbind") \
        else list(values)
    stack = torch.stack([c.to(torch.float32) for c in cols], dim=1)
    n, a = stack.shape

    def other_k1():
        out = torch.zeros(total, a, device="cuda")
        if k1(slot.data_ptr(), stack.data_ptr(), n, a, total,
              out.data_ptr(), stream()):
            raise RuntimeError("other dense_grid_sum launch failed")
        return out

    loc2d, kst, tile = recorded["bucketed_groupby_sums"]
    nb, cap, ka = kst.shape

    def other_k3():
        out = torch.zeros(nb, tile, ka, device="cuda")
        if k3(loc2d.data_ptr(), kst.data_ptr(), nb, cap, ka, tile,
              out.data_ptr(), stream()):
            raise RuntimeError("other bucketed_groupby_sums launch failed")
        return out

    col_bytes = sum(n * c.element_size() for c in cols)
    cases = {
        "K1 stack": ("dense_grid_sum", n * 4 + n * a * 4 + total * a * 4,
                     other_k1, lambda: hk.dense_grid_sum(slot, stack, total)),
        "K1 columns": ("dense_grid_sum", n * 4 + col_bytes + total * a * 4,
                       None, lambda: hk.dense_grid_sum(slot, cols, total)),
        "K3": ("bucketed_groupby_sums",
               nb * cap * 4 + nb * cap * ka * 4 + nb * tile * ka * 4,
               other_k3, lambda: hk.bucketed_groupby_sums(loc2d, kst, tile)),
    }
    for label, (_match, _nbytes, other, this) in cases.items():
        if other is not None:
            want, got = other(), this()
            scale = want.abs().amax(dim=tuple(range(want.dim() - 1))) + 1.0
            if not bool(torch.all((got - want).abs() <= 1e-4 * scale)):
                raise AssertionError(f"{label}: this tree's kernel "
                                     "disagrees with ROOT's")
    bound = {k: c[1] / cs.HBM_BYTES_PER_S * 1e3 for k, c in cases.items()}
    for turn in ("root", "this", "this", "root"):
        for label, (match, _nbytes, other, this) in cases.items():
            fn = other if turn == "root" else this
            if fn is None:
                continue
            dev = cs.device_ms(fn, match=match)
            cs.log(f"compare {label} {turn}: device {dev!r} ms at cold L2 "
                   f"({bound[label] / dev:.1%} of the {bound[label]!r} ms "
                   f"bound), call {cs.time_ms(fn)!r} ms ({ident})")
    idx = torch.where((slot >= 0) & (slot < total), slot.long(),
                      torch.full_like(slot, total, dtype=torch.long))
    k1_out = torch.zeros(total + 1, a, device="cuda")
    flat = (loc2d.long() + torch.arange(nb, device="cuda")[:, None]
            * tile).reshape(-1)
    k3_vals = kst.reshape(nb * cap, ka)
    k3_out = torch.zeros(nb * tile, ka, device="cuda")
    for label, fn in (("K1", lambda: k1_out.index_add_(0, idx, stack)),
                      ("K3", lambda: k3_out.index_add_(0, flat, k3_vals))):
        cs.log(f"compare {label} library index_add_: device "
               f"{cs.device_ms(fn)!r} ms at cold L2, call "
               f"{cs.time_ms(fn)!r} ms ({ident})")


def warm(data_dir, root, reps) -> int:
    """Q1 and the nullable aggregate, warm and profiled, through the
    citus_tpu_torch package under `root` on an existing data_dir."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import citus_tpu_torch as ct
    from citus_tpu_torch.ingest import tpch

    ident = cs.card_identity()
    sess = ct.connect(data_dir)
    for q, sql in (("Q1", tpch.QUERIES["Q1"]),
                   ("nullable", cs.NULLABLE_SQL)):
        table = "lineitem" if q == "Q1" else "lineitem_nullable"
        rows = int(sess.execute(f"select count(*) from {table}").rows()[0][0])
        sess.execute(sql)  # the first run reads the stripes
        torch.cuda.synchronize()
        cs.warm_runs(sess, q, sql, rows, reps, ident)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="the older checkout")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--warm", metavar="DATA_DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.warm:
        return warm(args.warm, args.root, args.reps)
    import torch

    if not torch.cuda.is_available():
        print("compare_grid_sums: no CUDA device is visible", file=sys.stderr)
        return 2
    import citus_tpu_torch as ct
    from citus_tpu_torch.ingest import tpch
    from citus_tpu_torch.ops import hopper_kernels as hk

    ident = cs.card_identity()
    cs.log(ident)
    hk.build_all()
    tmp = tempfile.mkdtemp(prefix="citus_port_compare_")
    try:
        data_dir = os.path.join(tmp, "data")
        li = tpch.generate_tables(args.sf, seed=0)["lineitem"]
        sess = ct.connect(data_dir)
        tpch.load_tables(sess, {"lineitem": li}, tables={"lineitem"})
        cs.load_nullable(sess, li, tpch)
        recorders = {n: cs.Recorder(hk, n)
                     for n in ("dense_grid_sum", "bucketed_groupby_sums")}
        for r in recorders.values():
            r.install()
        try:
            cs.check_q1(sess.execute(tpch.QUERIES["Q1"]), cs.numpy_q1(li))
            cs.check_high_card(sess.execute(cs.HIGH_CARD_SQL),
                               cs.numpy_high_card(li))
        finally:
            for r in recorders.values():
                r.remove()
        compare_kernels(hk, args.root,
                        {n: r.args for n, r in recorders.items()}, ident)
        del sess
        for turn in ("root", "this", "this", "root"):
            pkg = args.root if turn == "root" else REPO
            cs.log(f"compare queries {turn} ({pkg}):")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            pkg, "--warm", data_dir, "--reps",
                            str(args.reps)], check=True, timeout=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
