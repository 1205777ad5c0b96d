// Native stripe codec: decompress + decode column chunks straight into
// preallocated, device-ready numpy buffers.
//
// Structural analogue of the reference's C read path
// (Citus src/backend/columnar/columnar_reader.c:839
// DeserializeChunkData + columnar_compression.c:166 DecompressBuffer),
// redesigned for this engine's stripe layout: chunks are fixed-width
// little-endian value buffers, so decompression lands bytes directly at
// the chunk's row offset in the output array — no per-row datum loop, no
// post-hoc concatenate.  Validity bitmaps unpack MSB-first (numpy
// packbits order) into byte-per-row bool arrays.
//
// Threads split the chunk list; on a 1-core host this degrades to the
// single-thread loop, on co-located many-core hardware each column scan
// parallelizes for free.  All entry points return 0 on success and a
// negative errno-style code on failure; the Python caller falls back to
// the pure-Python chunk loop on ANY nonzero result.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <unistd.h>
#include <thread>
#include <vector>
#include <atomic>

#include <zlib.h>
#ifndef NO_ZSTD
#include <zstd.h>
#endif

namespace {

constexpr int kCodecNone = 0;
constexpr int kCodecZlib = 1;
constexpr int kCodecZstd = 2;

// one decompress task: file range -> destination byte range
struct Task {
  int64_t src_off, src_clen, src_rlen;
  int64_t dst_off;   // byte offset into out
  int64_t rows;      // validity only
  int64_t dst_row;   // validity only
  bool has_bitmap;   // validity only
};

// per-thread decompression state: chunks are ~10k rows (tens of KB), so
// one-shot APIs that allocate a fresh context per call pay allocation +
// table setup on every chunk — a reused ZSTD_DCtx / z_stream is the
// classic small-buffer decompression win
struct Codec {
#ifndef NO_ZSTD
  ZSTD_DCtx* dctx = nullptr;
#endif
  ~Codec() {
#ifndef NO_ZSTD
    if (dctx) ZSTD_freeDCtx(dctx);
#endif
  }

  int decompress_into(int codec, const uint8_t* src, int64_t clen,
                      uint8_t* dst, int64_t rlen) {
    if (codec == kCodecNone) {
      if (clen != rlen) return -2;
      std::memcpy(dst, src, static_cast<size_t>(rlen));
      return 0;
    }
    if (codec == kCodecZlib) {
      uLongf out_len = static_cast<uLongf>(rlen);
      if (uncompress(dst, &out_len, src, static_cast<uLong>(clen)) != Z_OK)
        return -3;
      if (static_cast<int64_t>(out_len) != rlen) return -3;
      return 0;
    }
#ifndef NO_ZSTD
    if (codec == kCodecZstd) {
      if (!dctx) dctx = ZSTD_createDCtx();
      if (!dctx) return -4;
      size_t got = ZSTD_decompressDCtx(
          dctx, dst, static_cast<size_t>(rlen), src,
          static_cast<size_t>(clen));
      if (ZSTD_isError(got) || static_cast<int64_t>(got) != rlen)
        return -4;
      return 0;
    }
#endif
    return -5;  // unknown / unsupported codec
  }
};

// worker: each thread owns a scratch buffer for compressed bytes and
// (for validity) the packed bitmap; pread keeps the fd shareable
void run_tasks(int fd, int codec, const std::vector<Task>& tasks,
               std::atomic<int64_t>& next, std::atomic<int>& err,
               uint8_t* out, bool validity) {
  Codec cd;
  std::vector<uint8_t> scratch;
  std::vector<uint8_t> packed;
  for (;;) {
    int64_t i = next.fetch_add(1);
    if (i >= static_cast<int64_t>(tasks.size()) || err.load() != 0) return;
    const Task& t = tasks[static_cast<size_t>(i)];
    if (validity && !t.has_bitmap) {
      std::memset(out + t.dst_row, 1, static_cast<size_t>(t.rows));
      continue;
    }
    if (scratch.size() < static_cast<size_t>(t.src_clen))
      scratch.resize(static_cast<size_t>(t.src_clen));
    int64_t got = pread(fd, scratch.data(),
                        static_cast<size_t>(t.src_clen), t.src_off);
    if (got != t.src_clen) { err.store(-6); return; }
    if (!validity) {
      int rc = cd.decompress_into(codec, scratch.data(), t.src_clen,
                               out + t.dst_off, t.src_rlen);
      if (rc != 0) { err.store(rc); return; }
      continue;
    }
    if (packed.size() < static_cast<size_t>(t.src_rlen))
      packed.resize(static_cast<size_t>(t.src_rlen));
    int rc = cd.decompress_into(codec, scratch.data(), t.src_clen,
                             packed.data(), t.src_rlen);
    if (rc != 0) { err.store(rc); return; }
    // MSB-first bit unpack (numpy packbits order) -> byte-per-row bools
    uint8_t* dst = out + t.dst_row;
    for (int64_t r = 0; r < t.rows; ++r)
      dst[r] = (packed[static_cast<size_t>(r >> 3)] >>
                (7 - (r & 7))) & 1;
  }
}

int run_all(const char* path, int codec, const std::vector<Task>& tasks,
            uint8_t* out, bool validity, int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n = n_threads > 0 ? n_threads : (hw > 0 ? hw : 1);
  if (n > static_cast<int>(tasks.size()))
    n = static_cast<int>(tasks.size());
  if (n <= 1) {
    run_tasks(fd, codec, tasks, next, err, out, validity);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(n));
    for (int i = 0; i < n; ++i)
      threads.emplace_back(run_tasks, fd, codec, std::cref(tasks),
                           std::ref(next), std::ref(err), out, validity);
    for (auto& th : threads) th.join();
  }
  close(fd);
  return err.load();
}

}  // namespace

extern "C" {

// values: decompress n_chunks file ranges into `out` at dst_off bytes
int64_t ct_decode_column(const char* path, int32_t codec,
                         const int64_t* voff, const int64_t* vclen,
                         const int64_t* vrlen, const int64_t* dst_off,
                         int64_t n_chunks, uint8_t* out,
                         int64_t out_bytes, int32_t n_threads) {
  std::vector<Task> tasks(static_cast<size_t>(n_chunks));
  for (int64_t i = 0; i < n_chunks; ++i) {
    Task& t = tasks[static_cast<size_t>(i)];
    t.src_off = voff[i]; t.src_clen = vclen[i]; t.src_rlen = vrlen[i];
    t.dst_off = dst_off[i];
    if (t.dst_off < 0 || t.dst_off + t.src_rlen > out_bytes) return -7;
  }
  return run_all(path, codec, tasks, out, /*validity=*/false, n_threads);
}

// validity: unpack n_chunks bitmaps into byte-per-row bools at dst_row;
// chunks with nclen == 0 carry no bitmap (all rows valid)
int64_t ct_decode_validity(const char* path, int32_t codec,
                           const int64_t* noff, const int64_t* nclen,
                           const int64_t* nrlen, const int64_t* rows,
                           const int64_t* dst_row, int64_t n_chunks,
                           uint8_t* out, int64_t total_rows,
                           int32_t n_threads) {
  std::vector<Task> tasks(static_cast<size_t>(n_chunks));
  for (int64_t i = 0; i < n_chunks; ++i) {
    Task& t = tasks[static_cast<size_t>(i)];
    t.src_off = noff[i]; t.src_clen = nclen[i]; t.src_rlen = nrlen[i];
    t.rows = rows[i]; t.dst_row = dst_row[i];
    t.has_bitmap = nclen[i] > 0;
    if (t.dst_row < 0 || t.dst_row + t.rows > total_rows) return -7;
    if (t.has_bitmap && t.src_rlen * 8 < t.rows) return -7;
  }
  return run_all(path, codec, tasks, out, /*validity=*/true, n_threads);
}

}  // extern "C"
