// msdb_host — native host-side runtime for myscaledb_tpu_torch: the parts of
// native/msdb_host.cpp (the JAX package's host library) that the port calls.
//
// The reference implements its host data plane in C++ (tokenizers for the FTS
// index, LowCardinality ingest in src/Columns/).  String dictionary encoding
// and corpus tokenization are implemented here and exposed over a C ABI
// consumed via ctypes (myscaledb_tpu_torch/native.py), with the LZ block
// codec of on-disk parts (storage/codecs.py, codec "lz"): its compressor
// writes the JAX library's bytes.  The JAX library's partition hashing and
// CSV column parsing come with the slices that call them.
//
// Build: at first use, ops/kernels/build.py::host_library() runs
// c++ -O3 -fPIC -std=c++17 -shared on this file into
// myscaledb_tpu_torch/_build/libmsdb_host-<hash>.so.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <deque>

extern "C" {

// ---------------------------------------------------------------------------
// string dictionary encoding (LowCardinality ingest).
// input: concatenated utf-8 bytes + (n+1) int64 offsets.
// output: int32 ids; unique strings returned as concatenated bytes+offsets
// through an opaque result handle (caller copies then frees).

struct EncodeResult {
    std::vector<int32_t> ids;
    std::string uniq_bytes;
    std::vector<int64_t> uniq_offsets;   // size n_uniq+1
};

void* msdb_dict_encode(const char* bytes, const int64_t* offsets, int64_t n,
                       const char* seed_bytes, const int64_t* seed_offsets,
                       int64_t n_seed) {
    auto* res = new EncodeResult();
    res->ids.resize(static_cast<size_t>(n));
    res->uniq_offsets.push_back(0);
    // keys live in a deque: elements never relocate, so string_view map keys
    // stay valid as the dictionary grows
    std::deque<std::string> keys;
    std::unordered_map<std::string_view, int32_t> map;
    map.reserve(static_cast<size_t>(n / 2 + n_seed + 16));
    auto add_unique = [&](std::string_view sv) -> int32_t {
        int32_t id = static_cast<int32_t>(map.size());
        keys.emplace_back(sv);
        map.emplace(std::string_view(keys.back()), id);
        res->uniq_bytes.append(sv);
        res->uniq_offsets.push_back(static_cast<int64_t>(res->uniq_bytes.size()));
        return id;
    };
    // seed with an existing dictionary (ids must stay stable across inserts)
    for (int64_t i = 0; i < n_seed; ++i) {
        add_unique(std::string_view(
            seed_bytes + seed_offsets[i],
            static_cast<size_t>(seed_offsets[i + 1] - seed_offsets[i])));
    }
    for (int64_t i = 0; i < n; ++i) {
        std::string_view sv(bytes + offsets[i],
                            static_cast<size_t>(offsets[i + 1] - offsets[i]));
        auto it = map.find(sv);
        res->ids[static_cast<size_t>(i)] =
            (it == map.end()) ? add_unique(sv) : it->second;
    }
    return res;
}

int64_t msdb_dict_result_n_uniq(void* handle) {
    return static_cast<int64_t>(
        static_cast<EncodeResult*>(handle)->uniq_offsets.size()) - 1;
}
int64_t msdb_dict_result_uniq_bytes(void* handle) {
    return static_cast<int64_t>(
        static_cast<EncodeResult*>(handle)->uniq_bytes.size());
}
void msdb_dict_result_copy(void* handle, int32_t* ids_out, char* bytes_out,
                           int64_t* offsets_out) {
    auto* r = static_cast<EncodeResult*>(handle);
    std::memcpy(ids_out, r->ids.data(), r->ids.size() * sizeof(int32_t));
    std::memcpy(bytes_out, r->uniq_bytes.data(), r->uniq_bytes.size());
    std::memcpy(offsets_out, r->uniq_offsets.data(),
                r->uniq_offsets.size() * sizeof(int64_t));
}
void msdb_dict_result_free(void* handle) {
    delete static_cast<EncodeResult*>(handle);
}

// ---------------------------------------------------------------------------
// tokenizer for the BM25 index: lowercase [a-z0-9]+ runs (matches
// myscaledb_tpu_torch/text/bm25.py::tokenize).  Tokenizes a whole corpus in one
// call, building the vocabulary and emitting per-token term ids + doc ids.

struct TokenizeResult {
    std::vector<int32_t> term_ids;   // per token
    std::vector<int32_t> doc_ids;    // per token
    std::string vocab_bytes;
    std::vector<int64_t> vocab_offsets;
};

void* msdb_tokenize_corpus(const char* bytes, const int64_t* offsets,
                           int64_t n_docs) {
    auto* res = new TokenizeResult();
    res->vocab_offsets.push_back(0);
    std::unordered_map<std::string, int32_t> vocab;
    std::string tok;
    for (int64_t di = 0; di < n_docs; ++di) {
        const char* p = bytes + offsets[di];
        const char* end = bytes + offsets[di + 1];
        tok.clear();
        for (; p <= end; ++p) {
            char c = (p < end) ? *p : ' ';
            if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
            bool alnum = (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
            if (alnum) {
                tok.push_back(c);
            } else if (!tok.empty()) {
                auto it = vocab.find(tok);
                int32_t tid;
                if (it == vocab.end()) {
                    tid = static_cast<int32_t>(vocab.size());
                    vocab.emplace(tok, tid);
                    res->vocab_bytes.append(tok);
                    res->vocab_offsets.push_back(
                        static_cast<int64_t>(res->vocab_bytes.size()));
                } else {
                    tid = it->second;
                }
                res->term_ids.push_back(tid);
                res->doc_ids.push_back(static_cast<int32_t>(di));
                tok.clear();
            }
        }
    }
    return res;
}

int64_t msdb_tok_n_tokens(void* h) {
    return static_cast<int64_t>(static_cast<TokenizeResult*>(h)->term_ids.size());
}
int64_t msdb_tok_n_vocab(void* h) {
    return static_cast<int64_t>(
        static_cast<TokenizeResult*>(h)->vocab_offsets.size()) - 1;
}
int64_t msdb_tok_vocab_bytes(void* h) {
    return static_cast<int64_t>(static_cast<TokenizeResult*>(h)->vocab_bytes.size());
}
void msdb_tok_copy(void* h, int32_t* term_ids, int32_t* doc_ids,
                   char* vocab_bytes, int64_t* vocab_offsets) {
    auto* r = static_cast<TokenizeResult*>(h);
    std::memcpy(term_ids, r->term_ids.data(),
                r->term_ids.size() * sizeof(int32_t));
    std::memcpy(doc_ids, r->doc_ids.data(),
                r->doc_ids.size() * sizeof(int32_t));
    std::memcpy(vocab_bytes, r->vocab_bytes.data(), r->vocab_bytes.size());
    std::memcpy(vocab_offsets, r->vocab_offsets.data(),
                r->vocab_offsets.size() * sizeof(int64_t));
}
void msdb_tok_free(void* h) { delete static_cast<TokenizeResult*>(h); }

// ---------------------------------------------------------------------------
// fast LZ block codec ("msdb-lz"): greedy hash-chain LZ77, byte-aligned
// format (the LZ4-class slot in src/Compression/).  Token layout per LZ4:
//   [token: 4b lit_len | 4b match_len] [ext lit len bytes] [literals]
//   [2B little-endian offset] [ext match len bytes]
// match_len stored as len-4 (min match 4); final block is literals-only.

static inline uint32_t lz_hash(uint32_t v) { return (v * 2654435761u) >> 19; } // 13-bit

int64_t msdb_lz_compress_bound(int64_t n) { return n + n / 255 + 64; }

int64_t msdb_lz_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
    const int64_t HASH_SIZE = 1 << 13;
    std::vector<int64_t> table(HASH_SIZE, -1);
    int64_t ip = 0, op = 0, anchor = 0;
    if (n >= 13) {
        const int64_t mflimit = n - 12;
        while (ip < mflimit) {
            uint32_t seq;
            std::memcpy(&seq, src + ip, 4);
            uint32_t h = lz_hash(seq);
            int64_t ref = table[h];
            table[h] = ip;
            uint32_t refseq = 0;
            if (ref >= 0 && ip - ref <= 65535) {
                std::memcpy(&refseq, src + ref, 4);
            }
            if (ref < 0 || ip - ref > 65535 || refseq != seq) {
                ++ip;
                continue;
            }
            // extend match
            int64_t mlen = 4;
            while (ip + mlen < n - 5 && src[ref + mlen] == src[ip + mlen]) ++mlen;
            int64_t litlen = ip - anchor;
            // emit token
            uint8_t* token = dst + op++;
            if (litlen >= 15) {
                *token = 0xF0;
                int64_t l = litlen - 15;
                for (; l >= 255; l -= 255) dst[op++] = 255;
                dst[op++] = static_cast<uint8_t>(l);
            } else {
                *token = static_cast<uint8_t>(litlen << 4);
            }
            std::memcpy(dst + op, src + anchor, static_cast<size_t>(litlen));
            op += litlen;
            uint16_t off = static_cast<uint16_t>(ip - ref);
            dst[op++] = static_cast<uint8_t>(off & 0xFF);
            dst[op++] = static_cast<uint8_t>(off >> 8);
            int64_t mstore = mlen - 4;
            if (mstore >= 15) {
                *token |= 0x0F;
                int64_t m = mstore - 15;
                for (; m >= 255; m -= 255) dst[op++] = 255;
                dst[op++] = static_cast<uint8_t>(m);
            } else {
                *token |= static_cast<uint8_t>(mstore);
            }
            ip += mlen;
            anchor = ip;
        }
    }
    // final literal run
    int64_t litlen = n - anchor;
    uint8_t* token = dst + op++;
    if (litlen >= 15) {
        *token = 0xF0;
        int64_t l = litlen - 15;
        for (; l >= 255; l -= 255) dst[op++] = 255;
        dst[op++] = static_cast<uint8_t>(l);
    } else {
        *token = static_cast<uint8_t>(litlen << 4);
    }
    std::memcpy(dst + op, src + anchor, static_cast<size_t>(litlen));
    op += litlen;
    return op;
}

int64_t msdb_lz_decompress(const uint8_t* src, int64_t srclen, uint8_t* dst,
                           int64_t dstlen) {
    // the same format as the JAX package's decoder; every read of the
    // frame is bounds-checked, since it comes from a file on disk
    int64_t ip = 0, op = 0;
    while (ip < srclen) {
        uint8_t token = src[ip++];
        int64_t litlen = token >> 4;
        if (litlen == 15) {
            uint8_t b;
            do {
                if (ip >= srclen) return -1;
                b = src[ip++];
                litlen += b;
            } while (b == 255);
        }
        if (op + litlen > dstlen || ip + litlen > srclen) return -1;
        std::memcpy(dst + op, src + ip, static_cast<size_t>(litlen));
        ip += litlen;
        op += litlen;
        if (ip >= srclen) break;   // final literals-only block
        if (ip + 2 > srclen) return -1;
        uint16_t off = static_cast<uint16_t>(src[ip] | (src[ip + 1] << 8));
        ip += 2;
        int64_t mlen = (token & 0x0F);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= srclen) return -1;
                b = src[ip++];
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (off == 0 || op - off < 0 || op + mlen > dstlen) return -1;
        // overlapping copy must be byte-wise
        for (int64_t i = 0; i < mlen; ++i) dst[op + i] = dst[op - off + i];
        op += mlen;
    }
    return op;
}

}  // extern "C"
