// Bucketed probe gather: out[b, j] = dir2d[b, loc2d[b, j]].
//
// Replaces: citus_tpu/ops/pallas_kernels.py bucketed_probe_pallas, the
// inner gather of citus_tpu/ops/join.py bucketed_unique_lookup (TPC-H
// Q3's orders⋈lineitem fused lookup once the o_orderkey directory spans
// ≥ 2^22 slots).
//
// Bound on H100: bytes.  The directory is read once (nb·tile·4 bytes),
// each probe slot read once and each result written once (2·nb·cap·4),
// so the floor is (nb·tile + 2·nb·cap)·4 / 3.35 TB/s: 0.0359 ms for the
// main path's dir2d [184 × 32768] and loc2d [184 × 65280].  A random
// gather straight from device memory would instead pay a 32-byte sector
// per probe; the probe stream is already packed by directory tile, so
// the tile is staged on chip and every gather hits shared memory.
//
// First design: one block of 512 threads per (bucket, half of the
// bucket's probes), 368 blocks at SF1, one per SM at a time (the 128 KB
// tile).  Each block copied its whole tile, waited at __syncthreads and
// only then gathered, one 4-byte probe and one 4-byte result per thread
// per iteration: no probe load was in flight while the tile streamed in,
// and every tile was staged twice.  It took 0.074–0.078 ms on an H100 at
// 700 W (CUDA events, back-to-back wrapper calls, L2 warm) and 0.074 ms
// of device time at cold L2, behind torch.gather's 0.069 / 0.071 ms.
//
// Design: persistent blocks, one of 1024 threads per SM.  Each block
// takes one contiguous range of the flat [nb·cap] probe array (cut on
// 4-slot boundaries) and restages its tile only where the range crosses
// into another bucket: about nb + #SMs tile loads instead of 2·nb.  Odd
// blocks walk their range's buckets last to first, even blocks first to
// last, so both blocks that share a bucket stage it at about the same
// time and one of the two reads is served from L2.  The
// tile arrives by the bulk copy engine (cp.async.bulk into shared memory,
// completion on an mbarrier), issued by one warp; meanwhile every thread
// issues its first probe loads, and it waits on the barrier only before
// its first gather.  Probes are read and results written as 16-byte
// vectors, kUnroll of them in flight per thread (64 KB per SM) with the
// next batch loaded before the current one is gathered.  A bucket's
// vector part starts and ends on a 4-slot boundary of the flat array;
// when cap·4 is not a multiple of 16 its row begins and ends mid-vector,
// and those head and tail slots are read one by one.  The bulk copy needs
// a 16-byte aligned tile of a multiple of 16 bytes: any other tile (the
// tests use 1022 slots), or a misaligned dir2d, is staged by a plain
// per-thread copy; a misaligned loc2d or out takes scalar probes
// throughout.  Slots outside [0, tile) clamp into the tile (the pack's
// garbage lanes hold slot 0; their results are never read).  The SM count
// and the shared-memory opt-in are set once per process.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxSmem = 232448;
constexpr int kCopyChunk = 16384;  // bytes per bulk-copy instruction

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Warp 0 copies `bytes` (a multiple of 16) from src into the tile; the
// barrier's phase completes when all of them have landed.
__device__ __forceinline__ void bulk_stage(int* tile_s, const int* src,
                                           int bytes, uint32_t bar) {
  const int lane = threadIdx.x & 31;
  // the generic-proxy reads of the previous tile, ordered by the caller's
  // __syncthreads, come before this async-proxy overwrite
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar),
        "r"(bytes)
        : "memory");
  }
  __syncwarp();
  const uint32_t dst = smem_u32(tile_s);
  for (int off = lane * kCopyChunk; off < bytes; off += 32 * kCopyChunk) {
    const int n = bytes - off < kCopyChunk ? bytes - off : kCopyChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst + off),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ int probe(const int* __restrict__ tile_s,
                                     int tile, int l) {
  l = l < 0 ? 0 : (l >= tile ? tile - 1 : l);
  return tile_s[l];
}

__device__ __forceinline__ void load_vecs(int4 (&w)[kUnroll],
                                          const int4* __restrict__ l4,
                                          long long v, long long n4) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = v + (long long)u * kThreads;
    w[u] = i < n4 ? __ldg(l4 + i) : make_int4(0, 0, 0, 0);
  }
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads, 1)
bucketed_probe_kernel(const int* __restrict__ dir2d,
                      const int* __restrict__ loc2d, int tile, long long cap,
                      long long total, int vec, int* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* tile_s = reinterpret_cast<int*>(smem4);
  // this block's range of the flat probe array, cut on 4-slot boundaries
  const long long per =
      (((total + gridDim.x - 1) / gridDim.x) + 3) & ~3LL;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = lo + per < total ? lo + per : total;
  if (lo >= hi) return;
  const uint32_t bar = smem_u32(tile_s + tile);  // kBulk: tile·4 % 16 == 0
  if (kBulk && threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  uint32_t phase = 0;
  // odd blocks walk their buckets last to first (see the note above)
  const long long first = lo / cap, last = (hi - 1) / cap;
  for (long long k = 0; k <= last - first; ++k) {
    const long long b = (blockIdx.x & 1) ? last - k : first + k;
    const long long s = b * cap > lo ? b * cap : lo;
    const long long e = (b + 1) * cap < hi ? (b + 1) * cap : hi;
    const int* src = dir2d + b * (long long)tile;
    if (kBulk && threadIdx.x < 32) bulk_stage(tile_s, src, tile * 4, bar);
    // [s, vs) head and [ve, e) tail one by one, [vs, ve) as vectors
    long long vs = e, ve = e;
    if (vec) {
      vs = (s + 3) & ~3LL;
      if (vs > e) vs = e;
      ve = e & ~3LL;
      if (ve < vs) ve = vs;
    }
    const long long n4 = (ve - vs) >> 2;
    const int4* l4 = reinterpret_cast<const int4*>(loc2d + vs);
    int4* o4 = reinterpret_cast<int4*>(out + vs);
    long long v = threadIdx.x;
    int4 cur[kUnroll];
    load_vecs(cur, l4, v, n4);  // in flight while the tile arrives
    if constexpr (kBulk) {
      mbar_wait(bar, phase);
      phase ^= 1;
    } else {
      for (int i = threadIdx.x; i < tile; i += kThreads)
        tile_s[i] = __ldg(src + i);
      __syncthreads();
    }
    const long long step = (long long)kThreads * kUnroll;
    for (; v < n4; v += step) {
      int4 nxt[kUnroll];
      load_vecs(nxt, l4, v + step, n4);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = v + (long long)u * kThreads;
        if (i < n4) {
          int4 r;
          r.x = probe(tile_s, tile, cur[u].x);
          r.y = probe(tile_s, tile, cur[u].y);
          r.z = probe(tile_s, tile, cur[u].z);
          r.w = probe(tile_s, tile, cur[u].w);
          o4[i] = r;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    }
    for (long long i = s + threadIdx.x; i < vs; i += kThreads)
      out[i] = probe(tile_s, tile, __ldg(loc2d + i));
    for (long long i = ve + threadIdx.x; i < e; i += kThreads)
      out[i] = probe(tile_s, tile, __ldg(loc2d + i));
    __syncthreads();  // every read of this tile done before the next lands
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

// Opt the kernel into the full 227 KB of shared memory once per process.
template <bool kBulk>
cudaError_t opt_in() {
  static const cudaError_t err =
      cudaFuncSetAttribute(bucketed_probe_kernel<kBulk>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  return err;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bucketed_probe_launch(const void* dir2d, const void* loc2d,
                                     long long nb, long long tile,
                                     long long cap, void* out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = nb * cap;
  if (total <= 0) return 0;
  const long long tile_bytes = tile * 4;
  // the bulk copy's barrier sits just past the tile
  const bool bulk = (tile_bytes & 15) == 0
                    && (reinterpret_cast<uintptr_t>(dir2d) & 15) == 0
                    && tile_bytes + 8 <= kMaxSmem;
  const int vec = ((reinterpret_cast<uintptr_t>(loc2d)
                    | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  long long blocks = (total + 16383) / 16384;
  if (blocks > sm_count()) blocks = sm_count();
  const cudaError_t e = bulk ? opt_in<true>() : opt_in<false>();
  if (e != cudaSuccess) return (int)e;
  if (bulk) {
    bucketed_probe_kernel<true><<<(unsigned)blocks, kThreads,
                                  (size_t)(tile_bytes + 8), st>>>(
        static_cast<const int*>(dir2d), static_cast<const int*>(loc2d),
        (int)tile, cap, total, vec, static_cast<int*>(out));
  } else {
    bucketed_probe_kernel<false><<<(unsigned)blocks, kThreads,
                                   (size_t)tile_bytes, st>>>(
        static_cast<const int*>(dir2d), static_cast<const int*>(loc2d),
        (int)tile, cap, total, vec, static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}
