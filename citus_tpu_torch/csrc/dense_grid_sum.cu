// Dense-grid segment sum: sums[k, a] = sum over rows i with slot[i] == k
// of values[i, a], for k < total; rows whose slot lies outside [0, total)
// (the executor parks invalid rows at slot == total) are ignored.
//
// Replaces: citus_tpu/ops/pallas_kernels.py dense_grid_aggregate_pallas,
// the kernel form of citus_tpu/executor/compiler.py _dense_segment_sum
// (TPC-H Q1's low-cardinality GROUP BY).
//
// Bound on H100: bytes.  Each row is read once (4-byte slot + 4·A bytes
// of values) and the [total, A] output is tiny, so the floor is
// N·(4 + 4A) / 3.35 TB/s.  The TPU kernel fed a one-hot × values product
// to the MXU; here that would spend (total+1)·A multiply-adds per row for
// nothing, so the sum is a scatter instead.
//
// Design: a grid-stride loop over rows.  Each block privatizes the whole
// [total, A] grid in shared memory (opted in above 48 KB) and adds rows
// into it with shared-memory atomics, then merges its partial into the
// zeroed output with one global atomicAdd per cell.  When the grid does
// not fit shared memory, rows add straight into the output with global
// atomics.  Sums are f32 in an order that varies from run to run (the
// atomics), so results agree with a sequential sum to f32 rounding, and
// 0/1 count stacks stay exact while a slot collects fewer than 2^24 rows.
// Few slots means heavy contention on the same shared addresses; warp-level
// pre-aggregation is the next step when this kernel is made fast.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;

__global__ void dense_grid_sum_smem(const int* __restrict__ slot,
                                    const float* __restrict__ vals,
                                    long long n, int a, int total,
                                    float* __restrict__ out) {
  extern __shared__ float acc[];
  const int cells = total * a;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int s = slot[i];
    if (s >= 0 && s < total) {
      const float* row = vals + i * a;
      float* dst = acc + (long long)s * a;
      for (int j = 0; j < a; ++j) atomicAdd(dst + j, row[j]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(out + i, v);
  }
}

__global__ void dense_grid_sum_global(const int* __restrict__ slot,
                                      const float* __restrict__ vals,
                                      long long n, int a, int total,
                                      float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int s = slot[i];
    if (s >= 0 && s < total) {
      const float* row = vals + i * a;
      float* dst = out + (long long)s * a;
      for (int j = 0; j < a; ++j) atomicAdd(dst + j, row[j]);
    }
  }
}

}  // namespace

// out must be zeroed by the caller.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int dense_grid_sum_launch(const void* slot, const void* vals,
                                     long long n, long long a,
                                     long long total, void* out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long smem = total * a * (long long)sizeof(float);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (n + kThreads - 1) / kThreads;
  if (smem <= kMaxSmemBytes) {
    cudaFuncSetAttribute(dense_grid_sum_smem,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    // a few blocks per SM: each block pays one merge of total·A cells
    long long cap = (long long)sms * 4;
    int blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
    dense_grid_sum_smem<<<blocks, kThreads, (size_t)smem, st>>>(
        static_cast<const int*>(slot), static_cast<const float*>(vals), n,
        (int)a, (int)total, static_cast<float*>(out));
  } else {
    long long cap = (long long)sms * 16;
    int blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
    dense_grid_sum_global<<<blocks, kThreads, 0, st>>>(
        static_cast<const int*>(slot), static_cast<const float*>(vals), n,
        (int)a, (int)total, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
