// Bucketed probe gather: out[b, j] = dir2d[b, loc2d[b, j]].
//
// Replaces: citus_tpu/ops/pallas_kernels.py bucketed_probe_pallas, the
// inner gather of citus_tpu/ops/join.py bucketed_unique_lookup (TPC-H
// Q3's orders⋈lineitem fused lookup once the o_orderkey directory spans
// ≥ 2^22 slots).
//
// Bound on H100: bytes.  The directory is read once (nb·tile·4 bytes),
// each probe slot read once and each result written once (2·nb·cap·4),
// so the floor is (nb·tile + 2·nb·cap)·4 / 3.35 TB/s.  A random gather
// straight from device memory would instead pay a 32-byte sector per
// probe; the probe stream is already packed by directory tile, so the
// tile is staged once and every gather hits shared memory.
//
// Design: one block per (bucket, chunk of probe rows).  The block copies
// its bucket's directory tile (32768 int32 = 128 KB at the planner's
// tile size) into dynamic shared memory with 16-byte loads, then each
// thread gathers its probe slots from shared memory and writes the
// results coalesced.  Slots outside [0, tile) clamp into the tile (the
// pack's garbage lanes hold slot 0; their results are never read).
// 128 KB of shared memory allows one block per SM; chunks per bucket are
// chosen so the grid covers every SM at least twice.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void bucketed_probe_kernel(const int* __restrict__ dir2d,
                                      const int* __restrict__ loc2d,
                                      int tile, long long cap, long long chunk,
                                      int* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* tile_s = reinterpret_cast<int*>(smem4);
  const long long b = blockIdx.y;
  const int* src = dir2d + b * tile;
  if ((tile & 3) == 0) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < (tile >> 2); i += blockDim.x)
      smem4[i] = src4[i];
  } else {
    for (int i = threadIdx.x; i < tile; i += blockDim.x) tile_s[i] = src[i];
  }
  __syncthreads();
  const long long lo = (long long)blockIdx.x * chunk;
  long long hi = lo + chunk;
  if (hi > cap) hi = cap;
  const long long base = b * cap;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    int l = loc2d[base + j];
    l = l < 0 ? 0 : (l >= tile ? tile - 1 : l);
    out[base + j] = tile_s[l];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bucketed_probe_launch(const void* dir2d, const void* loc2d,
                                     long long nb, long long tile,
                                     long long cap, void* out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = (int)(tile * (long long)sizeof(int));
  cudaFuncSetAttribute(bucketed_probe_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long splits = (2LL * sms + nb - 1) / nb;
  if (splits < 1) splits = 1;
  long long chunk = (cap + splits - 1) / splits;
  if (chunk < kThreads) chunk = kThreads;
  splits = (cap + chunk - 1) / chunk;
  dim3 grid((unsigned)splits, (unsigned)nb);
  bucketed_probe_kernel<<<grid, kThreads, (size_t)smem, st>>>(
      static_cast<const int*>(dir2d), static_cast<const int*>(loc2d),
      (int)tile, cap, chunk, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
