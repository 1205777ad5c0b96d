// Dictionary decode: out[i] = lut[codes[i]] over a flat [rows·cap] code
// array, codes uint8 or uint16, values float32 or float64.
//
// Replaces: citus_tpu/ops/pallas_kernels.py dict_decode_pallas, called by
// citus_tpu/executor/scanpipe.py _expand_dict: a low-NDV float column of
// a scan_pipeline=device feed (TPC-H l_quantity, l_discount, l_tax)
// crosses the host→device link as 1–2 byte codes plus a small value table
// and expands on the card.
//
// Bound on H100: bytes.  Each code is read once, each value written once
// and the table read once: (n·code_bytes + n·value_bytes + nv·value_bytes)
// / 3.35 TB/s.  A gather from device memory would pay a 32-byte sector
// per code instead of value_bytes, so the table has to sit on chip.
//
// Design: the TPU kernel kept the whole table resident in VMEM and
// gathered a 512-code chunk per grid step.  Here, when the table fits the
// 227 KB of shared memory a block may opt into, each block stages it
// there once (16-byte loads where aligned) and then walks a grid-stride
// loop over the codes: neighbouring threads read neighbouring codes and
// write neighbouring values, and every gather hits shared memory.  The
// grid is a few blocks per SM, so the table is staged a few hundred times
// at most (256 values: 1 KB each).  A table too large for shared memory
// (65,536 float32 values are 256 KB) is read through the read-only cache
// instead; the wrapper picks the variant by the table's byte size.  Codes
// are not range-checked, as in the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

template <typename C, typename V>
__global__ void dict_decode_smem(const C* __restrict__ codes, long long n,
                                 const V* __restrict__ lut, int nv,
                                 V* __restrict__ out) {
  extern __shared__ int4 smem4[];
  V* lut_s = reinterpret_cast<V*>(smem4);
  const int bytes = nv * (int)sizeof(V);
  if ((bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
    const int4* src = reinterpret_cast<const int4*>(lut);
    for (int i = threadIdx.x; i < (bytes >> 4); i += blockDim.x)
      smem4[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < nv; i += blockDim.x) lut_s[i] = lut[i];
  }
  __syncthreads();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = lut_s[codes[i]];
}

template <typename C, typename V>
__global__ void dict_decode_global(const C* __restrict__ codes, long long n,
                                   const V* __restrict__ lut,
                                   V* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __ldg(lut + codes[i]);
}

template <typename C, typename V>
int launch(const void* codes, long long n, const void* lut, long long nv,
           bool smem, void* out, cudaStream_t st) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  if (blocks < 1) blocks = 1;
  const C* c = static_cast<const C*>(codes);
  const V* l = static_cast<const V*>(lut);
  V* o = static_cast<V*>(out);
  if (smem) {
    const size_t bytes = (size_t)nv * sizeof(V);
    cudaFuncSetAttribute(dict_decode_smem<C, V>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    dict_decode_smem<C, V><<<(unsigned)blocks, kThreads, bytes, st>>>(
        c, n, l, (int)nv, o);
  } else {
    dict_decode_global<C, V><<<(unsigned)blocks, kThreads, 0, st>>>(
        c, n, l, o);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// codes [n] of code_bytes (1 or 2) unsigned bytes each, lut [nv] of
// value_bytes (4 = float32, 8 = float64) → out [n].  smem != 0 stages the
// table in shared memory (the wrapper checks nv·value_bytes fits).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for widths the kernel does not take.
extern "C" int dict_decode_launch(const void* codes, long long n,
                                  long long code_bytes, const void* lut,
                                  long long nv, long long value_bytes,
                                  long long smem, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const bool s = smem != 0;
  if (code_bytes == 1 && value_bytes == 4)
    return launch<uint8_t, float>(codes, n, lut, nv, s, out, st);
  if (code_bytes == 1 && value_bytes == 8)
    return launch<uint8_t, double>(codes, n, lut, nv, s, out, st);
  if (code_bytes == 2 && value_bytes == 4)
    return launch<uint16_t, float>(codes, n, lut, nv, s, out, st);
  if (code_bytes == 2 && value_bytes == 8)
    return launch<uint16_t, double>(codes, n, lut, nv, s, out, st);
  return (int)cudaErrorInvalidValue;
}
