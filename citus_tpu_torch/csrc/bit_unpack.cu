// Validity-plane bit unpack: out[r, i] = bit (7 - i % 8) of packed[r, i / 8]
// for i < cap (numpy packbits order, MSB first), as bool bytes 0/1.
//
// Replaces: citus_tpu/ops/pallas_kernels.py bit_unpack_pallas, called by
// citus_tpu/executor/scanpipe.py _expand_bits: the null planes of a
// scan_pipeline=device feed cross the host→device link packed 8:1 and
// expand on the card.
//
// Bound on H100: bytes.  Each packed byte is read once and each output
// byte written once, so the floor is rows·(cap/8 + cap) / 3.35 TB/s:
// 0.0020 ms for the main path's one plane of 750,192 packed bytes into
// 6,001,536 bools (a 1-D plane per column, cap a multiple of 128).  The
// bit arithmetic (a multiply, a mask and a byte permute per 4 outputs) is
// nothing beside that.
//
// First design (one thread per packed byte, one 8-byte store each, 64-bit
// division of the flat index by the row width): 0.0051 ms at cold L2 on
// the main path, 39% of the bound, on an H100 at 700 W.
//
// Design: what held the first one back, and what this one does about it:
// - 750K threads, about 2.8 waves per SM, each waiting one DRAM latency
//   on a single 1-byte load: here the grid is at most one wave (the SM
//   count is read once per process), every thread starts the loads of
//   kUnroll units before any store, and a grid-stride loop covers the
//   rest;
// - a 64-bit integer division per thread (software, ~70 instructions):
//   here there is none.  A flat plane (rows == 1, or 8·w == cap: the
//   output is the unpack of the packed bytes in order) is one segment;
//   ragged rows (8·w > cap) take their row from blockIdx.y;
// - 8-byte stores (256 bytes per warp store instruction): the unit of
//   work here is one 16-byte output store made from 2 packed bytes (one
//   2-byte load).  Neighbouring lanes take neighbouring units, so every
//   warp instruction loads 64 contiguous bytes and stores 512.
// A segment whose output start is 8- but not 16-byte aligned writes its
// first packed byte alone; one whose start is not 8-byte aligned (a
// ragged row of a cap that is not a multiple of 8, or a misaligned out)
// is written a packed byte per thread with byte stores, as are the last
// bytes of every segment: nothing past cap is written.  An odd packed
// address (a packed[1:] view) loads each unit's 2 bytes one by one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;
constexpr long long kMaxGridY = 65535;

// bits 3..0 of nib → bytes 0..3 (MSB of the nibble to byte 0): the
// multiply puts bit k at byte k, the permute reverses the bytes
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return __byte_perm((nib * 0x00204081u) & 0x01010101u, 0, 0x0123);
}

// a 16-byte unit: the 8 bools of b0 (first in the plane), then b1's
__device__ __forceinline__ int4 spread16(uint32_t b0, uint32_t b1) {
  return make_int4((int)spread4(b0 >> 4), (int)spread4(b0 & 15u),
                   (int)spread4(b1 >> 4), (int)spread4(b1 & 15u));
}

// Segments r = blockIdx.y, blockIdx.y + gridDim.y, ... < rows, each the
// unpack of the n bits at packed + r·w into out + r·n.
__global__ void __launch_bounds__(kThreads)
bit_unpack_kernel(const uint8_t* __restrict__ packed, long long rows,
                  long long w, long long n, uint8_t* __restrict__ out) {
  const long long nb = (n + 7) >> 3;  // packed bytes a segment reads
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint8_t* src = packed + r * w;
    uint8_t* dst = out + r * n;
    const unsigned mis = (unsigned)reinterpret_cast<uintptr_t>(dst) & 15u;
    // packed bytes [0, head) and [tail, nb) are written byte by byte,
    // the nu units between them as 16-byte stores
    long long head = nb, nu = 0;
    if ((mis & 7u) == 0) {
      head = mis ? 1 : 0;
      if (head > nb) head = nb;
      if (n > 8 * head) nu = (n - 8 * head) >> 4;
    }
    const uint8_t* usrc = src + head;
    int4* udst = reinterpret_cast<int4*>(dst + 8 * head);
    const bool pairs = (reinterpret_cast<uintptr_t>(usrc) & 1u) == 0;
    const unsigned short* usrc2 =
        reinterpret_cast<const unsigned short*>(usrc);
    const long long step = (long long)gridDim.x * (kThreads * kUnroll);
    for (long long i = (long long)blockIdx.x * (kThreads * kUnroll)
                       + threadIdx.x;
         i < nu; i += step) {
      uint32_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + (long long)u * kThreads;
        if (j < nu)
          v[u] = pairs ? (uint32_t)__ldg(usrc2 + j)
                       : (uint32_t)__ldg(usrc + 2 * j)
                             | ((uint32_t)__ldg(usrc + 2 * j + 1) << 8);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + (long long)u * kThreads;
        if (j < nu) udst[j] = spread16(v[u] & 255u, v[u] >> 8);
      }
    }
    const long long tail = head + 2 * nu;
    const long long ns = head + (nb - tail);
    for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
         k < ns; k += (long long)gridDim.x * kThreads) {
      const long long s = k < head ? k : tail + (k - head);
      const uint32_t b = src[s];
      const long long o = 8 * s;
      const int m = n - o < 8 ? (int)(n - o) : 8;
      for (int q = 0; q < m; ++q) dst[o + q] = (b >> (7 - q)) & 1u;
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

}  // namespace

// packed [rows, w] uint8 → out [rows, cap] bool (cap ≤ 8·w).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bit_unpack_launch(const void* packed, long long rows,
                                 long long w, long long cap, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || w <= 0 || cap <= 0) return 0;
  // a flat plane is one segment of rows·cap bits
  long long segs = rows, n = cap;
  if (rows == 1 || 8 * w == cap) {
    segs = 1;
    n = rows * cap;
  }
  // blocks per segment: units when every segment starts 8-byte aligned,
  // else a packed byte per thread
  const bool units = (reinterpret_cast<uintptr_t>(out) & 7) == 0 &&
                     (segs == 1 || n % 8 == 0);
  const long long per_block = units ? 16LL * kThreads * kUnroll
                                    : 8LL * kThreads;
  const long long need = (n + per_block - 1) / per_block;
  const long long gy = segs < kMaxGridY ? segs : kMaxGridY;
  long long wave = (long long)kBlocksPerSm * sm_count() / gy;
  if (wave < 1) wave = 1;
  const long long steps = (need + wave - 1) / wave;
  const long long gx = (need + steps - 1) / steps;
  bit_unpack_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), segs, w, n,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
