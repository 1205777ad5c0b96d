// Dense-grid segment sum: sums[k, j] = sum over rows i with slot[i] == k
// of column j at row i, for k < total; rows whose slot lies outside
// [0, total) (the executor parks invalid rows at slot == total) are
// ignored.  Columns are float32, int32 or bool, each at its own address
// and element stride, and turn into float32 in registers.
//
// Replaces: citus_tpu/ops/pallas_kernels.py dense_grid_aggregate_pallas,
// the kernel form of citus_tpu/executor/compiler.py _dense_segment_sum
// (TPC-H Q1's low-cardinality GROUP BY).
//
// Bound on H100: bytes.  Each row's slot (4 bytes) and each column's
// element (4 bytes, 1 for bool) are read once and the [total, A] output
// is tiny, so the floor is (N·4 + Σ_j N·size_j + total·A·4) / 3.35 TB/s.
// The TPU kernel fed a one-hot × values product to the MXU; here that
// would spend (total+1)·A multiply-adds per row for nothing, so the sum
// is a scatter.
//
// First design: a grid-stride loop, one row per thread, every row adding
// its A values into one shared [total, A] grid per block with shared
// atomics.  TPC-H Q1 has 4 non-empty groups, so the 32 lanes of a warp hit
// about 4 addresses and each atomic instruction serialised 8–32 ways; and
// its input was a [N, A] float32 stack that the executor built with
// torch.stack and dtype copies, 3 launches of it plus one for the row
// count, each reading the slot column again.  It took 0.309 ms of device
// time at cold L2 per launch against a 0.043 ms bound (H100 80GB HBM3 at
// 700 W), and the stacks it needed cost 2.5 times the kernel.
//
// Design: the executor passes its columns as they lie (one launch takes up
// to kMaxCols columns; a [N, A] stack is A columns of stride A), through
// a by-value table of pointers, strides and types that each block copies
// to shared memory.  Neighbouring threads take neighbouring units of 4
// rows: one 16-byte slot load and, per column of stride 1 aligned at the
// unit, one 16-byte load (4 bytes for bool); other columns load their 4
// rows one by one.  The rows before the first 16-byte aligned slot and
// the last N mod 4 take a scalar pass in the same kernel.  The grid is
// privatised, by size:
// - per thread, while a block's copies fit kThreadGridBytes (Q1: 12 slots
//   × 6 columns, 72 KB): each thread adds its rows into its own copy with
//   a plain load and store, the copies laid out cell-major so the 32
//   lanes of a warp always hit 32 banks, whatever their slots.  A unit's
//   slot and up to kThreadBatch column loads are in flight at once.
// - per warp, while the block's warp copies fit kWarpGridBytes: rows of a
//   unit whose slots repeat fold into the last of the run in registers,
//   and the run ends go through warp pre-aggregation (warp_aggregate.cuh):
//   one add per distinct slot per warp per column, the shuffle schedule
//   worked out once per unit and replayed for each column; the leader
//   adds with a plain load and store into its warp's copy.
// - per block, the same aggregation with shared atomics; else leaders add
//   to the output with global atomics.
// Each block merges its copies into the zeroed output with one global
// atomic per non-zero cell.  tools/dense_grid_layouts.py times the
// layouts against each other on Q1's column call (6M rows, bool + 5
// float32; H100 80GB HBM3 at 700 W, device time at cold L2): per-thread
// copies 0.066–0.081 ms up to 16 slots, where per-warp copies take
// 0.124–0.139 ms, since matching and shuffling cost about 700 warp
// instructions per 128 rows and bind the kernel on issue; per-warp copies
// 0.11–0.14 ms up to 256 slots, 1.2× faster than every lane adding alone
// into one block grid on uniform slots and 7.7× on 4 hot slots.  Per
// block, pre-aggregation loses up to 27% on uniform slots and wins
// 3.5–4× on hot ones, so it stays; with global atomics it always wins,
// and lanes adding alone there drift 2.2e-4 of a column's sum on 4 hot
// slots.  The per-warp limit keeps 4 blocks per SM: with 3, per-block
// grids were faster on hot slots.  Up to 4 blocks of 256 threads per SM
// (3 with Q1's per-thread copies, 2 at 16 slots) walk the rows with a
// grid-stride loop; the SM count and the shared-memory opt-in are set
// once per process.  Sums are float32 in an order that varies from run to
// run (the merge's atomics), so results agree with a sequential sum to
// float32 rounding; 0/1 and int32 counts stay exact while a slot collects
// fewer than 2^24.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_aggregate.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxCols = 16;
// columns whose loads a unit has in flight: per-thread grids / the rest
constexpr int kThreadBatch = 8;
constexpr int kWarpBatch = 2;
constexpr int kMaxSmem = 232448;
constexpr int kSmPerSmem = 233472;  // shared memory of one SM
// per-thread grids while a block's copies fit this (2 blocks per SM),
// else per-warp grids while they fit kWarpGridBytes (4 blocks per SM)
constexpr int kThreadGridBytes = 96 * 1024;
constexpr int kWarpGridBytes = 55 * 1024;

enum Dtype : int { kF32 = 0, kI32 = 1, kBool = 2 };
enum Mode : int { kPerThread = 0, kPerWarp = 1, kPerBlock = 2, kGlobal = 3 };

struct Col {
  const void* ptr;
  long long stride;  // in elements
  int dtype;
  int vec;  // stride 1 and aligned: a unit's 4 rows are one load
};

struct Cols {
  Col c[kMaxCols];
};

// dynamic shared memory a block may take beside its column table
constexpr int kMaxDynSmem = kMaxSmem - (int)sizeof(Cols);

__device__ __forceinline__ float load1(const Col& c, long long r) {
  const long long i = r * c.stride;
  switch (c.dtype) {
    case kF32:
      return __ldg(static_cast<const float*>(c.ptr) + i);
    case kI32:
      return (float)__ldg(static_cast<const int*>(c.ptr) + i);
    default:
      return __ldg(static_cast<const unsigned char*>(c.ptr) + i) ? 1.f
                                                                 : 0.f;
  }
}

// Rows r .. r+R-1 of one column (0 where the unit is out of range).
template <int R>
__device__ __forceinline__ void load_rows(const Col& c, long long r, bool in,
                                          float (&v)[R]) {
  if (!in) {
#pragma unroll
    for (int u = 0; u < R; ++u) v[u] = 0.f;
    return;
  }
  if constexpr (R == 4) {
    if (c.vec) {
      if (c.dtype == kF32) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(
            static_cast<const float*>(c.ptr) + r));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      } else if (c.dtype == kI32) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(
            static_cast<const int*>(c.ptr) + r));
        v[0] = (float)x.x; v[1] = (float)x.y;
        v[2] = (float)x.z; v[3] = (float)x.w;
      } else {
        const unsigned w = __ldg(reinterpret_cast<const unsigned*>(
            static_cast<const unsigned char*>(c.ptr) + r));
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = (w >> (8 * u)) & 0xffu ? 1.f : 0.f;
      }
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < R; ++u) v[u] = load1(c, r + u);
}

// Load the rows of columns j0 .. j0+B-1 (those below a), all in flight
// at once.
template <int B, int R>
__device__ __forceinline__ void load_batch(const Col* col, int j0, int a,
                                           long long r, bool in,
                                           float (&v)[B][R]) {
#pragma unroll
  for (int k = 0; k < B; ++k)
    if (j0 + k < a) load_rows<R>(col[j0 + k], r, in, v[k]);
}

// Add rows r .. r+R-1 (slots s) of every column into the grid.  Called by
// all 32 lanes of the warp.  kPerThread: `grid` is this thread's copy,
// cell c at grid[c·kThreads].
template <int R, int kMode>
__device__ __forceinline__ void add_rows(const int (&s)[R], long long r,
                                         bool in, const Col* col, int a,
                                         int total, float* grid,
                                         float* __restrict__ out,
                                         long long ldo, int lane) {
  constexpr int B = kMode == kPerThread ? kThreadBatch : kWarpBatch;
  float v[B][R];
  load_batch<B, R>(col, 0, a, r, in, v);  // in flight while groups form
  // carry[u]: row u-1 folds into row u (same slot); end[u]: row u adds
  bool end[R], carry[R];
#pragma unroll
  for (int u = 0; u < R; ++u) end[u] = s[u] >= 0 && s[u] < total;
  if constexpr (kMode == kPerThread) {
    for (int j0 = 0;;) {
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const int j = j0 + k;
        if (j >= a) break;
#pragma unroll
        for (int u = 0; u < R; ++u)
          if (end[u]) grid[(s[u] * a + j) * kThreads] += v[k][u];
      }
      j0 += B;
      if (j0 >= a) return;
      load_batch<B, R>(col, j0, a, r, in, v);
    }
  }
  carry[0] = false;
#pragma unroll
  for (int u = 1; u < R; ++u) {
    carry[u] = end[u] && end[u - 1] && s[u] == s[u - 1];
    if (carry[u]) end[u - 1] = false;
  }
  warp_agg::Group g[R];
#pragma unroll
  for (int u = 0; u < R; ++u) g[u] = warp_agg::group_of(end[u], s[u], lane);
  for (int j0 = 0;;) {
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int j = j0 + k;
      if (j >= a) break;
#pragma unroll
      for (int u = 1; u < R; ++u)
        if (carry[u]) v[k][u] += v[k][u - 1];
      float x[R];
#pragma unroll
      for (int u = 0; u < R; ++u) x[u] = warp_agg::group_sum(v[k][u], g[u].s);
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (g[u].lead) {
          if constexpr (kMode == kGlobal) {
            atomicAdd(out + (long long)s[u] * ldo + j, x[u]);
          } else if constexpr (kMode == kPerBlock) {
            atomicAdd(grid + s[u] * a + j, x[u]);
          } else {
            grid[s[u] * a + j] += x[u];  // this warp's own copy
          }
        }
        if constexpr (kMode == kPerWarp) __syncwarp();
      }
    }
    j0 += B;
    if (j0 >= a) break;
    load_batch<B, R>(col, j0, a, r, in, v);
  }
}

// Units [0, nq) of 4 rows from row h, then rows [0, h) and [h + 4·nq, n)
// one per lane.
template <int kMode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dense_grid_sum_kernel(const int* __restrict__ slot, long long n, long long h,
                      long long nq, Cols cols, int a, int total,
                      float* __restrict__ out, long long ldo) {
  extern __shared__ float acc[];
  __shared__ Col col[kMaxCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cells = total * a;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) col[j] = cols.c[j];
  }
  if constexpr (kMode != kGlobal) {
    const int all = kMode == kPerThread ? kThreads * cells
                    : kMode == kPerWarp ? kWarps * cells : cells;
    for (int i = threadIdx.x; i < all; i += kThreads) acc[i] = 0.f;
  }
  __syncthreads();
  float* grid = kMode == kPerThread ? acc + threadIdx.x
                : kMode == kPerWarp ? acc + warp * cells : acc;
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + warp * 32;
  const int4* slot4 = reinterpret_cast<const int4*>(slot + h);
  for (long long q0 = first; q0 < nq; q0 += step) {  // warp-uniform
    const long long q = q0 + lane;
    const bool in = q < nq;
    int s[4] = {-1, -1, -1, -1};
    if (in) {
      const int4 x = __ldg(slot4 + q);
      s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
    }
    add_rows<4, kMode>(s, h + 4 * q, in, col, a, total, grid, out, ldo,
                       lane);
  }
  const long long tail = h + 4 * nq;
  const long long ns = h + (n - tail);
  for (long long m0 = first; m0 < ns; m0 += step) {
    const long long m = m0 + lane;
    const bool in = m < ns;
    const long long r = m < h ? m : tail + (m - h);
    const int s[1] = {in ? __ldg(slot + r) : -1};
    add_rows<1, kMode>(s, r, in, col, a, total, grid, out, ldo, lane);
  }
  if constexpr (kMode == kPerThread) {
    __syncthreads();
    for (int c = warp; c < cells; c += kWarps) {  // a warp per cell
      float v = 0.f;
      for (int t = lane; t < kThreads; t += 32) v += acc[c * kThreads + t];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_down_sync(warp_agg::kFull, v, o);
      if (lane == 0 && v != 0.f)
        atomicAdd(out + (long long)(c / a) * ldo + c % a, v);
    }
  } else if constexpr (kMode != kGlobal) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      float v = acc[i];
      if constexpr (kMode == kPerWarp) {
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v += acc[w * cells + i];
      }
      if (v != 0.f) atomicAdd(out + (long long)(i / a) * ldo + i % a, v);
    }
  }
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// Opt the shared-memory variants into the 227 KB (less the column table)
// once per process.
cudaError_t opt_in() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        dense_grid_sum_kernel<kPerThread>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dense_grid_sum_kernel<kPerWarp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dense_grid_sum_kernel<kPerBlock>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynSmem);
    return e;
  }();
  return err;
}

}  // namespace

// slot [n] int32; desc: a host array of 3·a int64, per column its device
// address, element stride and type (0 float32, 1 int32, 2 bool); a <=
// kMaxCols.  out: [total] rows of row stride ldo floats, columns 0..a-1,
// zeroed by the caller.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int dense_grid_sum_launch(const void* slot, long long n,
                                     const void* desc, long long a,
                                     long long total, void* out,
                                     long long ldo, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a < 1 || a > kMaxCols || total < 0 || ldo < a)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || total == 0) return 0;
  // rows before the first 16-byte aligned slot (slot is 4-byte aligned)
  long long h = (long long)((16 - (reinterpret_cast<uintptr_t>(slot) & 15))
                            & 15) / 4;
  if (h > n) h = n;
  const long long nq = (n - h) / 4;
  const long long* d = static_cast<const long long*>(desc);
  Cols cols{};
  for (int j = 0; j < a; ++j) {
    Col& c = cols.c[j];
    c.ptr = reinterpret_cast<const void*>(d[3 * j]);
    c.stride = d[3 * j + 1];
    c.dtype = (int)d[3 * j + 2];
    if (c.dtype < kF32 || c.dtype > kBool) return (int)cudaErrorInvalidValue;
    const long long size = c.dtype == kBool ? 1 : 4;
    c.vec = c.stride == 1 && (d[3 * j] + h * size) % (4 * size) == 0;
  }
  const long long cells = total * a;
  int mode = kGlobal;
  long long smem = 0;
  if (kThreads * cells * 4 <= kThreadGridBytes) {
    mode = kPerThread;
    smem = kThreads * cells * 4;
  } else if (kWarps * cells * 4 <= kWarpGridBytes) {
    mode = kPerWarp;
    smem = kWarps * cells * 4;
  } else if (cells * 4 <= kMaxDynSmem) {
    mode = kPerBlock;
    smem = cells * 4;
  }
  long long per_sm = kBlocksPerSm;
  if (smem) {
    const long long fit =
        kSmPerSmem / (smem + (long long)sizeof(Cols) + 1024);
    if (fit < per_sm) per_sm = fit < 1 ? 1 : fit;
    const cudaError_t e = opt_in();
    if (e != cudaSuccess) return (int)e;
  }
  long long need = (nq + kThreads - 1) / kThreads;
  if (need < 1) need = 1;
  const long long cap = per_sm * sm_count();
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  const int* s = static_cast<const int*>(slot);
  float* o = static_cast<float*>(out);
  if (mode == kPerThread)
    dense_grid_sum_kernel<kPerThread><<<blocks, kThreads, (size_t)smem, st>>>(
        s, n, h, nq, cols, (int)a, (int)total, o, ldo);
  else if (mode == kPerWarp)
    dense_grid_sum_kernel<kPerWarp><<<blocks, kThreads, (size_t)smem, st>>>(
        s, n, h, nq, cols, (int)a, (int)total, o, ldo);
  else if (mode == kPerBlock)
    dense_grid_sum_kernel<kPerBlock><<<blocks, kThreads, (size_t)smem, st>>>(
        s, n, h, nq, cols, (int)a, (int)total, o, ldo);
  else
    dense_grid_sum_kernel<kGlobal><<<blocks, kThreads, 0, st>>>(
        s, n, h, nq, cols, (int)a, (int)total, o, ldo);
  return (int)cudaGetLastError();
}
