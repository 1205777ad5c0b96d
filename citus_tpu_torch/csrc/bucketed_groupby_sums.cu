// Bucket-tiled group-by sums: for each bucket b,
//   out[b, k, :] = sum over i with loc2d[b, i] == k of stack[b, i, :]
// for k < tile.  Garbage lanes of the pack hold slot 0 with zeroed values,
// so they add exact zeros.
//
// Replaces: citus_tpu/ops/pallas_kernels.py bucketed_groupby_sums_pallas,
// the sum stacks (_sums) of citus_tpu/ops/groupby.py
// bucketed_grid_aggregate (the high-cardinality GROUP BY: ~1,465 tiles of
// 4096 slots at TPC-H SF1 for GROUP BY l_orderkey).
//
// Bound on H100: bytes.  Each packed lane is read once (4 + 4·A bytes)
// and each tile cell written once (nb·tile·A·4), so the floor is
// (nb·cap·(4 + 4A) + nb·tile·A·4) / 3.35 TB/s.  The TPU kernel built a
// one-hot tile for the MXU; here every lane lands on one of 4096 slots,
// so it is a shared-memory scatter.
//
// First design: one block of 512 threads per (bucket, row split), one
// lane per thread, every lane adding its A values into the block's
// shared [tile, A] accumulator with shared atomics, then a global atomic
// per non-zero cell into an output the wrapper had zero-filled.  Every
// lane was added, garbage included, and the runner sizes a bucket at
// twice its expected fill plus 128, so most lanes were the pack's
// garbage tail: 32 lanes of a warp adding 0 to slot 0 at once.  The valid
// lanes come in l_orderkey order, so neighbouring lanes repeat a slot 1–7
// times and conflicted too.  It took 0.381 ms of device time at cold L2
// against a 0.081 ms bound (H100 80GB HBM3 at 700 W).
//
// Design: a lane whose A values are all ±0 adds nothing (x + ±0 = x for
// every x the accumulator can hold, which starts at +0 and never turns
// to −0 by round-to-nearest addition), so it drops out: the garbage tail
// issues no atomics, and NaN still adds.  Neighbouring threads take
// neighbouring units of 4 lanes: one 16-byte loc2d load and the unit's
// 16·A contiguous bytes of stack as A float4 loads (A of 1 to 4 is a
// template parameter; wider stacks load one column at a time).  A unit
// whose lanes are all zero is skipped by the whole warp; lanes of a unit
// that repeat a slot fold into the last of the run in registers, and the
// run ends go through warp pre-aggregation (warp_aggregate.cuh): one
// shared atomic per distinct slot per warp per column.  Lanes before the
// first 16-byte aligned unit of a bucket and after its last (cap not a
// multiple of 4), and all lanes of a misaligned view, take a scalar pass.
// When one block owns a bucket (every launch at SF1, where nb >= 2 x 132
// SMs), it writes its whole accumulator, zeros included, with 16-byte
// stores into an output the wrapper left unfilled; when several row
// splits share a bucket they add non-zero cells into the zeroed output
// with global atomics.  The wrapper picks the split length and with it
// the output fill.  Blocks of 256 threads hold 16 KB of shared memory per
// column at tile 4096 (up to 6 blocks per SM at A = 2, 4 at A = 3); the
// wrapper splits stacks wider than 14 columns.  The f32 sums come out in
// run-dependent order; 0/1 counts are exact while a bucket holds fewer
// than 2^24 rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_aggregate.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ bool nonzero(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) != 0u;  // NaN counts
}

// Lanes j .. j+R-1 of a bucket (L: its loc2d row, S: its stack rows):
// R = 4 from a 16-byte aligned unit, or R = 1.  Called by all 32 lanes.
// A > 0: the stack has A columns; A == 0: `a` columns, loaded one column
// at a time.
template <int R, int A>
__device__ __forceinline__ void add_lanes(const int* __restrict__ L,
                                          const float* __restrict__ S,
                                          long long j, bool in, int a,
                                          int tile, float* acc, int lane) {
  constexpr int kVals = A > 0 ? R * A : 1;
  const int na = A > 0 ? A : a;
  int l[R];
  float v[kVals];
  bool end[R], carry[R];
#pragma unroll
  for (int u = 0; u < R; ++u) l[u] = -1;
  if (in) {
    if constexpr (R == 4) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(L + j));
      l[0] = x.x; l[1] = x.y; l[2] = x.z; l[3] = x.w;
    } else {
      l[0] = __ldg(L + j);
    }
  }
  if constexpr (A > 0) {
    if (in) {
      if constexpr (R == 4) {
        const float4* p = reinterpret_cast<const float4*>(S + j * A);
#pragma unroll
        for (int k = 0; k < A; ++k) {
          const float4 x = __ldg(p + k);
          v[4 * k] = x.x; v[4 * k + 1] = x.y;
          v[4 * k + 2] = x.z; v[4 * k + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < A; ++k) v[k] = __ldg(S + j * A + k);
      }
    }
  }
  // a lane adds when its slot is in the tile and a value is not ±0
#pragma unroll
  for (int u = 0; u < R; ++u) {
    bool any = false;
    if (in && l[u] >= 0 && l[u] < tile) {
      if constexpr (A > 0) {
#pragma unroll
        for (int k = 0; k < A; ++k) any = any || nonzero(v[u * A + k]);
      } else {
        for (int k = 0; k < na && !any; ++k)
          any = nonzero(__ldg(S + (j + u) * na + k));
      }
    }
    end[u] = any;
  }
  bool live = false;
#pragma unroll
  for (int u = 0; u < R; ++u) live = live || end[u];
  if (!__any_sync(warp_agg::kFull, live)) return;  // a garbage stretch
  // carry[u]: lane u-1 folds into lane u (same slot)
  carry[0] = false;
#pragma unroll
  for (int u = 1; u < R; ++u) {
    carry[u] = end[u] && end[u - 1] && l[u] == l[u - 1];
    if (carry[u]) end[u - 1] = false;
  }
  warp_agg::Group g[R];
#pragma unroll
  for (int u = 0; u < R; ++u) g[u] = warp_agg::group_of(end[u], l[u], lane);
  for (int k = 0; k < na; ++k) {
    float c[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if constexpr (A > 0) {
        c[u] = v[u * A + k];
      } else {
        c[u] = end[u] || (u + 1 < R && carry[u + 1])
                   ? __ldg(S + (j + u) * na + k) : 0.f;
      }
    }
#pragma unroll
    for (int u = 1; u < R; ++u)
      if (carry[u]) c[u] += c[u - 1];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const float x = warp_agg::group_sum(c[u], g[u].s);
      if (g[u].lead) atomicAdd(acc + l[u] * na + k, x);
    }
  }
}

template <int A>
__global__ void __launch_bounds__(kThreads)
bucketed_groupby_sums_kernel(const int* __restrict__ loc2d,
                             const float* __restrict__ stack, long long cap,
                             int a, int tile, long long rows, int vec,
                             float* __restrict__ out) {
  extern __shared__ float acc[];
  const int na = A > 0 ? A : a;
  const int cells = tile * na;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool cells4 = (cells & 3) == 0;
  float4* acc4 = reinterpret_cast<float4*>(acc);
  if (cells4) {
    for (int i = threadIdx.x; i < cells / 4; i += kThreads)
      acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < cells; i += kThreads) acc[i] = 0.f;
  }
  __syncthreads();
  const long long b = blockIdx.y;
  const long long lo = (long long)blockIdx.x * rows;
  const long long hi = lo + rows < cap ? lo + rows : cap;
  const long long base = b * cap;  // flat index of the bucket's lane 0
  const int* L = loc2d + base;
  const float* S = stack + base * na;
  // 4-lane units over [v0, v1): v0 the first lane whose flat index is a
  // multiple of 4 (both arrays 16-byte aligned there when `vec`)
  long long v0 = hi, v1 = hi;
  if (vec) {
    v0 = lo + (4 - (base + lo) % 4) % 4;
    if (v0 > hi) v0 = hi;
    v1 = v0 + (hi - v0) / 4 * 4;
  }
  for (long long u0 = v0 + 4LL * (warp * 32); u0 < v1;
       u0 += 4LL * kThreads) {  // warp-uniform
    const long long j = u0 + 4 * lane;
    add_lanes<4, A>(L, S, j, j < v1, a, tile, acc, lane);
  }
  const long long nh = v0 - lo;
  const long long ns = nh + (hi - v1);
  for (long long m0 = warp * 32; m0 < ns; m0 += kThreads) {
    const long long m = m0 + lane;
    const long long j = m < nh ? lo + m : v1 + (m - nh);
    add_lanes<1, A>(L, S, j, m < ns, a, tile, acc, lane);
  }
  __syncthreads();
  float* dst = out + b * (long long)cells;
  if (gridDim.x == 1) {
    // the bucket's only block: plain stores, zeros included
    if (cells4 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int i = threadIdx.x; i < cells / 4; i += kThreads)
        dst4[i] = acc4[i];
    } else {
      for (int i = threadIdx.x; i < cells; i += kThreads) dst[i] = acc[i];
    }
  } else {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const float v = acc[i];
      if (v != 0.f) atomicAdd(dst + i, v);
    }
  }
}

// Opt each variant into the full 227 KB once per process.
template <int A>
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      bucketed_groupby_sums_kernel<A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

template <int A>
int launch(const int* loc2d, const float* stack, long long nb, long long cap,
           int a, int tile, long long rows, int vec, float* out,
           cudaStream_t st) {
  const cudaError_t e = opt_in<A>();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)tile * a * sizeof(float);
  dim3 grid((unsigned)((cap + rows - 1) / rows), (unsigned)nb);
  bucketed_groupby_sums_kernel<A><<<grid, kThreads, smem, st>>>(
      loc2d, stack, cap, a, tile, rows, vec, out);
  return (int)cudaGetLastError();
}

}  // namespace

// loc2d [nb, cap] int32, stack [nb, cap, a] float32, out [nb, tile, a].
// rows: lanes per block, a multiple of 4; rows >= cap gives each bucket
// one block, which writes every cell of its tile, else out must be zeroed
// by the caller.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int bucketed_groupby_sums_launch(const void* loc2d,
                                            const void* stack, long long nb,
                                            long long cap, long long a,
                                            long long tile, long long rows,
                                            void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a < 1 || tile < 1 || rows < 4 || rows % 4 ||
      tile * a * (long long)sizeof(float) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (nb <= 0 || cap <= 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(loc2d) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(stack) & 15) == 0;
  const int* l = static_cast<const int*>(loc2d);
  const float* s = static_cast<const float*>(stack);
  float* o = static_cast<float*>(out);
  switch (a) {
    case 1: return launch<1>(l, s, nb, cap, 1, (int)tile, rows, vec, o, st);
    case 2: return launch<2>(l, s, nb, cap, 2, (int)tile, rows, vec, o, st);
    case 3: return launch<3>(l, s, nb, cap, 3, (int)tile, rows, vec, o, st);
    case 4: return launch<4>(l, s, nb, cap, 4, (int)tile, rows, vec, o, st);
    default:
      return launch<0>(l, s, nb, cap, (int)a, (int)tile, rows, vec, o, st);
  }
}
