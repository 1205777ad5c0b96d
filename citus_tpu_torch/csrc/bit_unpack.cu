// Validity-plane bit unpack: out[r, i] = bit (7 - i % 8) of packed[r, i / 8]
// for i < cap (numpy packbits order, MSB first), as bool bytes 0/1.
//
// Replaces: citus_tpu/ops/pallas_kernels.py bit_unpack_pallas, called by
// citus_tpu/executor/scanpipe.py _expand_bits: the null planes of a
// scan_pipeline=device feed cross the host→device link packed 8:1 and
// expand on the card.
//
// Bound on H100: bytes.  Each packed byte is read once and each output
// byte written once, so the floor is rows·(cap/8 + cap) / 3.35 TB/s; the
// nine shifts and masks per packed byte are nothing beside that.
//
// Design: the TPU kernel walked a sequential grid of 128-byte steps and
// picked each output lane's source byte with a lane gather.  Here every
// thread owns one packed byte and writes its eight output bytes as one
// 8-byte store: a warp reads 32 neighbouring bytes and writes 256
// neighbouring bytes, both coalesced.  Output rows start at r·cap, and
// cap is a multiple of 8 on the scan path (the feed capacity is a multiple
// of 128), so the vector stores are aligned; a ragged cap (or a row
// stride that breaks the alignment) takes the byte-store path for the
// bytes at the end of a row, and nothing past cap is written.  A
// grid-stride loop covers any row count with one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  // bits 3..0 of nib → bytes 0..3 (MSB of the nibble to byte 0)
  return ((nib >> 3) & 1u) | (((nib >> 2) & 1u) << 8) |
         (((nib >> 1) & 1u) << 16) | ((nib & 1u) << 24);
}

__global__ void bit_unpack_kernel(const uint8_t* __restrict__ packed,
                                  long long rows, long long w, long long cap,
                                  bool vec, uint8_t* __restrict__ out) {
  const long long total = rows * w;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / w;
    const long long i = idx - r * w;
    const long long o = i * 8;
    if (o >= cap) continue;
    const uint32_t b = packed[idx];
    uint8_t* dst = out + r * cap + o;
    if (vec && o + 8 <= cap) {
      uint2 v;
      v.x = spread4(b >> 4);
      v.y = spread4(b & 15u);
      *reinterpret_cast<uint2*>(dst) = v;
    } else {
      const long long n = cap - o < 8 ? cap - o : 8;
      for (long long k = 0; k < n; ++k) dst[k] = (b >> (7 - k)) & 1u;
    }
  }
}

}  // namespace

// packed [rows, w] uint8 → out [rows, cap] bool (cap ≤ 8·w).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bit_unpack_launch(const void* packed, long long rows,
                                 long long w, long long cap, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = rows * w;
  if (total <= 0) return 0;
  const bool vec = (cap % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 8 == 0);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  bit_unpack_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), rows, w, cap, vec,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
