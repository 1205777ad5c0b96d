// Native host kernels for the ingest hot path.
//
// The reference's bulk-ingest loop is C (multi_copy.c:315
// CitusSendTupleToPlacements: per-tuple parse -> hash -> route); this
// library is the TPU build's native analogue for the host-side pieces
// that stay per-value no matter how much numpy vectorization the Python
// layer does: string dictionary interning and string hash tokens.
//
// Interface contract (see citus_tpu/native/__init__.py):
//   strings are passed as one UTF-8 buffer plus int64 start/end offset
//   arrays (packed host-side with one str.join + one numpy scan).
//
// Build: g++ -O2 -shared -fPIC hashdict.cpp -o _native.so -lz

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

inline uint32_t fmix32(uint32_t h) {
    // murmur3 finalizer — must match catalog/distribution.py fmix32
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// murmur64a-style word-at-a-time hash (internal only — never persisted,
// so the exact function is free to change)
inline uint64_t hash_bytes(const char* p, size_t len) {
    const uint64_t m = 0xC6A4A7935BD1E995ull;
    uint64_t h = 0x9E3779B97F4A7C15ull ^ (len * m);
    while (len >= 8) {
        uint64_t k;
        std::memcpy(&k, p, 8);
        k *= m;
        k ^= k >> 47;
        k *= m;
        h ^= k;
        h *= m;
        p += 8;
        len -= 8;
    }
    uint64_t tail = 0;
    if (len) {
        std::memcpy(&tail, p, len);
        h ^= tail;
        h *= m;
    }
    h ^= h >> 47;
    h *= m;
    h ^= h >> 47;
    return h;
}

// Open-addressing hash table (linear probe, power-of-2) mapping strings
// to int32 codes.  Strings live in the caller's buffers; slots hold a
// code + a cached hash, with representative (ptr, len) per code in a
// side vector.  Purpose-built because std::unordered_map's per-node
// allocation dominated multi-million-entry interning batches.
struct InternTable {
    struct Slot {
        uint64_t hash;
        int32_t code;  // -1 = empty
    };
    std::vector<Slot> slots;
    std::vector<const char*> ptrs;
    std::vector<int32_t> lens;
    size_t mask;

    explicit InternTable(size_t expected) {
        size_t cap = 16;
        while (cap < expected * 2) cap <<= 1;
        slots.assign(cap, Slot{0, -1});
        ptrs.reserve(expected);
        lens.reserve(expected);
        mask = cap - 1;
    }

    // returns the code; new_code is used (and recorded) on first sight
    int32_t upsert(const char* p, int32_t len, int32_t new_code,
                   bool* inserted) {
        uint64_t h = hash_bytes(p, static_cast<size_t>(len));
        size_t i = static_cast<size_t>(h) & mask;
        for (;;) {
            Slot& s = slots[i];
            if (s.code < 0) {
                s.hash = h;
                s.code = new_code;
                ptrs.push_back(p);
                lens.push_back(len);
                *inserted = true;
                return new_code;
            }
            if (s.hash == h && lens[s.code] == len &&
                std::memcmp(ptrs[s.code], p, static_cast<size_t>(len)) == 0) {
                *inserted = false;
                return s.code;
            }
            i = (i + 1) & mask;
        }
    }

    void grow() {
        size_t cap = slots.size() * 2;
        std::vector<Slot> old;
        old.swap(slots);
        slots.assign(cap, Slot{0, -1});
        mask = cap - 1;
        for (const Slot& s : old) {
            if (s.code < 0) continue;
            size_t i = static_cast<size_t>(s.hash) & mask;
            while (slots[i].code >= 0) i = (i + 1) & mask;
            slots[i] = s;
        }
    }
};

// Persistent dictionary handle: the table plus an arena owning the new
// entries' bytes (caller buffers die after each call).  Kept alive across
// ingest batches so a D-entry dictionary costs O(new) per batch, not
// O(D + new).
struct CtDict {
    InternTable table;
    std::deque<std::string> arena;  // stable element addresses

    CtDict() : table(1 << 15) {}
};

}  // namespace

extern "C" {

// -- persistent dictionary handle -------------------------------------

void* ct_dict_new() { return new CtDict(); }

void ct_dict_free(void* h) { delete static_cast<CtDict*>(h); }

int64_t ct_dict_size(void* h) {
    return static_cast<int64_t>(static_cast<CtDict*>(h)->table.ptrs.size());
}

// Intern a batch against the handle's table (codes continue from the
// current size; new strings are copied into the handle's arena).  Same
// outputs as ct_intern_batch.
int64_t ct_dict_intern(void* h, const char* in_buf,
                       const int64_t* in_starts, const int64_t* in_ends,
                       int64_t in_n, int32_t* out_codes,
                       int64_t* new_indices) {
    CtDict* d = static_cast<CtDict*>(h);
    while ((d->table.ptrs.size() + static_cast<size_t>(in_n)) * 2 >
           d->table.slots.size()) {
        d->table.grow();
    }
    int64_t base = static_cast<int64_t>(d->table.ptrs.size());
    int64_t n_new = 0;
    bool inserted = false;
    for (int64_t i = 0; i < in_n; ++i) {
        const char* p = in_buf + in_starts[i];
        int32_t len = static_cast<int32_t>(in_ends[i] - in_starts[i]);
        int32_t code = d->table.upsert(
            p, len, static_cast<int32_t>(base + n_new), &inserted);
        if (inserted) {
            // re-point the just-inserted entry at arena-owned bytes
            d->arena.emplace_back(p, static_cast<size_t>(len));
            d->table.ptrs.back() = d->arena.back().data();
            new_indices[n_new++] = i;
        }
        out_codes[i] = code;
    }
    return n_new;
}

// int32 routing token per string: crc32 of the utf-8 bytes + murmur3
// finalizer — must match storage/dictionary.py string_hash_token.
void ct_string_hash_tokens(const char* buf, const int64_t* starts,
                           const int64_t* ends, int64_t n, int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        uint32_t crc = static_cast<uint32_t>(
            crc32(0L, reinterpret_cast<const Bytef*>(buf + starts[i]),
                  static_cast<uInt>(ends[i] - starts[i])));
        out[i] = static_cast<int32_t>(fmix32(crc));
    }
}

}  // extern "C"
