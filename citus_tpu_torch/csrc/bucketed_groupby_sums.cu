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
// Bound on H100: bytes.  Each packed row is read once (4 + 4·A bytes) and
// each tile cell written once (nb·tile·A·4), so the floor is
// (nb·cap·(4 + 4A) + nb·tile·A·4) / 3.35 TB/s.  The TPU kernel built a
// one-hot tile for the MXU; here every row lands on one of 4096 slots, so
// it is a shared-memory scatter with little contention.
//
// Design: one block per (bucket, row split) holds the bucket's [tile, A]
// f32 accumulator in dynamic shared memory (16 KB per column at tile 4096;
// the wrapper splits stacks wider than 13 columns), adds its rows with
// shared-memory atomics, and flushes non-zero cells into the zeroed
// output with global atomics (several splits may share a bucket).  The
// f32 sums come out in run-dependent order; 0/1 counts are exact while a
// bucket holds fewer than 2^24 rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void bucketed_groupby_sums_kernel(const int* __restrict__ loc2d,
                                             const float* __restrict__ stack,
                                             long long cap, int a, int tile,
                                             long long rows_per_split,
                                             float* __restrict__ out) {
  extern __shared__ float acc[];
  const long long b = blockIdx.y;
  const int cells = tile * a;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * rows_per_split;
  long long hi = lo + rows_per_split;
  if (hi > cap) hi = cap;
  const long long base = b * cap;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const int l = loc2d[base + j];
    if (l >= 0 && l < tile) {
      const float* row = stack + (base + j) * a;
      float* dst = acc + l * a;
      for (int k = 0; k < a; ++k) atomicAdd(dst + k, row[k]);
    }
  }
  __syncthreads();
  float* dst = out + b * (long long)cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(dst + i, v);
  }
}

}  // namespace

// out [nb, tile, a] must be zeroed by the caller.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int bucketed_groupby_sums_launch(const void* loc2d,
                                            const void* stack, long long nb,
                                            long long cap, long long a,
                                            long long tile, void* out,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = (int)(tile * a * (long long)sizeof(float));
  cudaFuncSetAttribute(bucketed_groupby_sums_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long splits = (2LL * sms + nb - 1) / nb;
  if (splits < 1) splits = 1;
  long long rows = (cap + splits - 1) / splits;
  if (rows < kThreads) rows = kThreads;
  splits = (cap + rows - 1) / rows;
  dim3 grid((unsigned)splits, (unsigned)nb);
  bucketed_groupby_sums_kernel<<<grid, kThreads, (size_t)smem, st>>>(
      static_cast<const int*>(loc2d), static_cast<const float*>(stack), cap,
      (int)a, (int)tile, rows, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
