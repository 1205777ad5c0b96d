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
// / 3.35 TB/s, 0.0090 ms for the main path's 6,001,536 uint8 codes and
// 51-value float32 table.  A gather from device memory would pay a
// 32-byte sector per code instead of value_bytes, so the table has to sit
// on chip.
//
// First design: a grid-stride loop of 4·132 blocks of 512 threads
// in which each thread loaded one code byte and stored one value per
// iteration.  It took 0.036–0.049 ms per call on an H100 at 700 W (CUDA
// events, back-to-back wrapper calls, L2 warm), behind index_select's
// 0.031 ms; its own device time at cold L2 is 0.013 ms (68% of the
// bound): the rest was the wrapper's host work per call.  A second design
// gave each thread one 16-byte load of 16 codes and four 16-byte stores
// of their 64 contiguous output bytes, and took 0.023 ms at cold L2;
// likely because each warp store instruction wrote 32 half sectors 64
// bytes apart.
//
// Design: the unit of work is the codes of one 16-byte output store (4
// float32 or 2 float64 values: 2 to 8 bytes of codes).  Neighbouring
// threads take neighbouring units, so every warp instruction reads one
// contiguous run of codes and writes 512 contiguous bytes; each thread
// keeps kUnroll units in flight, and the first are loaded before the
// block stages the table.  The grid is at most 8 blocks of 256 threads
// per SM, sized so that every block walks the same number of steps.
// When the table fits the 227 KB of shared memory a block may opt into,
// each block stages it there once (16-byte loads where aligned) and
// every gather hits shared memory (a 51-value float32 table conflicts at
// most 2-way across the 32 banks); a larger table (65,536 float32 values
// are 256 KB) is read through the read-only cache.  The wrapper picks the
// variant by the table's byte size.  Units need codes aligned to a unit
// and a 16-byte aligned output: a misaligned view (codes[1:]) is decoded
// one code per thread by a grid-stride loop, which also takes the last n
// mod 4 (or 2) codes of an aligned array.  Codes are not range-checked, as
// in the TPU kernel.  The SM count and the shared-memory opt-in are set
// once per process (per template instance), not per call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxSmem = 232448;

// the codes of one 16-byte store: kCodes = 16 / sizeof(V) codes of C
template <int kBytes> struct UnitOf;
template <> struct UnitOf<2> { using T = unsigned short; };
template <> struct UnitOf<4> { using T = unsigned int; };
template <> struct UnitOf<8> { using T = uint2; };

__device__ __forceinline__ unsigned word(unsigned short u, int) { return u; }
__device__ __forceinline__ unsigned word(unsigned int u, int) { return u; }
__device__ __forceinline__ unsigned word(uint2 u, int k) {
  return k ? u.y : u.x;
}

__device__ __forceinline__ int4 pack(const float* v) {
  return make_int4(__float_as_int(v[0]), __float_as_int(v[1]),
                   __float_as_int(v[2]), __float_as_int(v[3]));
}

__device__ __forceinline__ int4 pack(const double* v) {
  return make_int4(__double2loint(v[0]), __double2hiint(v[0]),
                   __double2loint(v[1]), __double2hiint(v[1]));
}

template <bool kSmem, typename V>
__device__ __forceinline__ V lookup(const V* __restrict__ t, unsigned c) {
  if constexpr (kSmem) {
    return t[c];
  } else {
    return __ldg(t + c);
  }
}

// Stage the table in shared memory (every thread of the block takes part).
template <typename V>
__device__ __forceinline__ void stage_table(int4* smem4,
                                            const V* __restrict__ lut,
                                            int nv) {
  const int bytes = nv * (int)sizeof(V);
  if ((bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
    const int4* src = reinterpret_cast<const int4*>(lut);
    for (int i = threadIdx.x; i < (bytes >> 4); i += blockDim.x)
      smem4[i] = __ldg(src + i);
  } else {
    V* lut_s = reinterpret_cast<V*>(smem4);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) lut_s[i] = lut[i];
  }
}

// Load this thread's kUnroll units of the block step at `i`.
template <typename U>
__device__ __forceinline__ void load_units(U (&w)[kUnroll],
                                           const U* __restrict__ units,
                                           long long i, long long nu) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = i + (long long)u * kThreads;
    if (j < nu) w[u] = __ldg(units + j);
  }
}

// The 16 bytes of values of one unit of codes.
template <typename C, typename V, bool kSmem, typename U>
__device__ __forceinline__ int4 decode(const U w, const V* __restrict__ t) {
  constexpr int kCodes = 16 / (int)sizeof(V);
  constexpr int kPer = 4 / (int)sizeof(C);
  constexpr int kBits = 8 * (int)sizeof(C);
  constexpr unsigned kMask = (1u << kBits) - 1u;
  V vals[kCodes];
#pragma unroll
  for (int k = 0; k < kCodes; ++k)
    vals[k] = lookup<kSmem>(t, (word(w, k / kPer) >> (kBits * (k % kPer)))
                                   & kMask);
  return pack(vals);
}

// nu whole units (codes aligned to a unit and out to 16 bytes; 0 when
// they are not), then codes [nu·kCodes, n) one by one across the grid.
template <typename C, typename V, bool kSmem>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dict_decode_kernel(const C* __restrict__ codes, long long n, long long nu,
                   const V* __restrict__ lut, int nv, V* __restrict__ out) {
  extern __shared__ int4 smem4[];
  constexpr int kCodes = 16 / (int)sizeof(V);
  using U = typename UnitOf<kCodes * (int)sizeof(C)>::T;
  const U* units = reinterpret_cast<const U*>(codes);
  int4* out4 = reinterpret_cast<int4*>(out);
  const long long step = (long long)gridDim.x * (kThreads * kUnroll);
  long long i = (long long)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  U w[kUnroll];
  load_units(w, units, i, nu);  // in flight while the table is staged
  const V* t = lut;
  if constexpr (kSmem) {
    stage_table(smem4, lut, nv);
    __syncthreads();
    t = reinterpret_cast<const V*>(smem4);
  }
  for (; i < nu; i += step) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + (long long)u * kThreads;
      if (j < nu) out4[j] = decode<C, V, kSmem>(w[u], t);
    }
    load_units(w, units, i + step, nu);
  }
  for (long long j = nu * kCodes + (long long)blockIdx.x * kThreads
                     + threadIdx.x;
       j < n; j += (long long)gridDim.x * kThreads)
    out[j] = lookup<kSmem>(t, (unsigned)codes[j]);
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

// Opt a shared-memory kernel into the full 227 KB once per process.
template <typename C, typename V>
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      dict_decode_kernel<C, V, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

template <typename C, typename V>
int launch(const void* codes, long long n, const void* lut, long long nv,
           bool smem, void* out, cudaStream_t st) {
  const C* c = static_cast<const C*>(codes);
  const V* l = static_cast<const V*>(lut);
  V* o = static_cast<V*>(out);
  constexpr long long kCodes = 16 / sizeof(V);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(codes) % (kCodes * sizeof(C))) == 0
      && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long nu = aligned ? n / kCodes : 0;
  const size_t bytes = smem ? (size_t)nv * sizeof(V) : 0;
  // blocks an SM holds: kBlocksPerSm, fewer for a large table
  long long per_sm = kBlocksPerSm;
  if (smem) {
    const long long fit = 233472LL / ((long long)bytes + 1024);
    if (fit < per_sm) per_sm = fit < 1 ? 1 : fit;
  }
  const long long per_block = nu ? kThreads * kUnroll * kCodes
                                 : (long long)kThreads;
  const long long need = (n + per_block - 1) / per_block;
  const long long cap = per_sm * sm_count();
  const long long steps = (need + cap - 1) / cap;
  const unsigned g = (unsigned)((need + steps - 1) / steps);
  if (smem) {
    const cudaError_t e = opt_in<C, V>();
    if (e != cudaSuccess) return (int)e;
    dict_decode_kernel<C, V, true><<<g, kThreads, bytes, st>>>(
        c, n, nu, l, (int)nv, o);
  } else {
    dict_decode_kernel<C, V, false><<<g, kThreads, 0, st>>>(
        c, n, nu, l, (int)nv, o);
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
