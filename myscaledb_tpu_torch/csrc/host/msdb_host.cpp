// msdb_host — native host-side runtime for myscaledb_tpu_torch: the parts of
// native/msdb_host.cpp (the JAX package's host library) that the port calls.
//
// The reference implements its host data plane in C++ (tokenizers for the FTS
// index, LowCardinality ingest in src/Columns/).  String dictionary encoding
// and corpus tokenization are implemented here and exposed over a C ABI
// consumed via ctypes (myscaledb_tpu_torch/native.py), with the LZ block
// codec of on-disk parts (storage/codecs.py, codec "lz"): its compressor
// writes the JAX library's bytes; and the file formats' column work
// (runtime/formats.py): the JAX library's typed column parsers, an exact
// Float64 parser, date parsers, a CSV splitter with Python's csv.reader
// semantics, JSONEachRow and RowBinary scanners and the writers' row
// assembler.  The JAX library's partition hashing has no caller there (a
// distributed INSERT hashes its shard key on the device) and is left out.
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

// ---------------------------------------------------------------------------
// file formats (myscaledb_tpu_torch/runtime/formats.py).  Column at a time:
// the text readers split a whole file into fields, then parse one column's
// fields at once; the writers assemble rows from per-column pieces.

// typed text column parsers.  The *_column forms are the JAX library's
// (n + 1 contiguous offsets); the *_spans forms read field i from
// bytes[starts[i], ends[i]).  Each returns n, or the index of the first
// field it cannot parse.

int64_t msdb_parse_int64_spans(const char* bytes, const int64_t* starts,
                               const int64_t* ends, int64_t n, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const char* p = bytes + starts[i];
        const char* end = bytes + ends[i];
        bool neg = false;
        if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
        if (p == end) return i;   // empty -> error at row i
        uint64_t v = 0;           // wraps as the JAX library's int64 does
        for (; p < end; ++p) {
            if (*p < '0' || *p > '9') return i;
            v = v * 10 + static_cast<uint64_t>(*p - '0');
        }
        out[i] = static_cast<int64_t>(neg ? 0 - v : v);
    }
    return n;
}

int64_t msdb_parse_int64_column(const char* bytes, const int64_t* offsets,
                                int64_t n, int64_t* out) {
    return msdb_parse_int64_spans(bytes, offsets, offsets + 1, n, out);
}

int64_t msdb_parse_float32_spans(const char* bytes, const int64_t* starts,
                                 const int64_t* ends, int64_t n, float* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t len = ends[i] - starts[i];
        char buf[64];
        if (len <= 0 || len >= 63) return i;
        std::memcpy(buf, bytes + starts[i], static_cast<size_t>(len));
        buf[len] = 0;
        char* endp = nullptr;
        out[i] = strtof(buf, &endp);
        if (endp != buf + len) return i;
    }
    return n;
}

int64_t msdb_parse_float32_column(const char* bytes, const int64_t* offsets,
                                  int64_t n, float* out) {
    return msdb_parse_float32_spans(bytes, offsets, offsets + 1, n, out);
}

// Float64 read exactly (strtod, correctly rounded): the JAX package parses
// Float64 columns through the Float32 parser above.
int64_t msdb_parse_float64_spans(const char* bytes, const int64_t* starts,
                                 const int64_t* ends, int64_t n, double* out) {
    std::string big;
    for (int64_t i = 0; i < n; ++i) {
        int64_t len = ends[i] - starts[i];
        if (len <= 0) return i;
        char small[64];
        char* buf = small;
        if (len >= 63) {
            big.assign(bytes + starts[i], static_cast<size_t>(len));
            buf = &big[0];
        } else {
            std::memcpy(small, bytes + starts[i], static_cast<size_t>(len));
            small[len] = 0;
        }
        char* endp = nullptr;
        out[i] = strtod(buf, &endp);
        if (endp != buf + len) return i;
    }
    return n;
}

// proleptic Gregorian days <-> civil dates (H. Hinnant's algorithms)
static int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
    y -= m <= 2;
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const int64_t yoe = y - era * 400;
    const int64_t doy = (153 * (m > 2 ? m - 3 : m + 9) + 2) / 5 + d - 1;
    const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

static void civil_from_days(int64_t z, int64_t* y, int64_t* m, int64_t* d) {
    z += 719468;
    const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
    const int64_t doe = z - era * 146097;
    const int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
    const int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
    const int64_t mp = (5 * doy + 2) / 153;
    *d = doy - (153 * mp + 2) / 5 + 1;
    *m = mp < 10 ? mp + 3 : mp - 9;
    *y = yoe + era * 400 + (*m <= 2);
}

static bool digits(const char* p, int k, int64_t* v) {
    int64_t x = 0;
    for (int j = 0; j < k; ++j) {
        if (p[j] < '0' || p[j] > '9') return false;
        x = x * 10 + (p[j] - '0');
    }
    *v = x;
    return true;
}

static bool parse_ymd(const char* p, int64_t* days) {
    int64_t y, m, d;
    if (!digits(p, 4, &y) || p[4] != '-' || !digits(p + 5, 2, &m) ||
        p[7] != '-' || !digits(p + 8, 2, &d))
        return false;
    static const int dim[12] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
    bool leap = (y % 4 == 0 && y % 100 != 0) || y % 400 == 0;
    if (y < 1 || m < 1 || m > 12 || d < 1 ||
        d > dim[m - 1] + (m == 2 && leap))
        return false;
    *days = days_from_civil(y, m, d);
    return true;
}

// "YYYY-MM-DD" -> days since 1970-01-01.  Other spellings numpy's
// datetime64 parser takes are left to it (the index of the first is
// returned).
int64_t msdb_parse_date_spans(const char* bytes, const int64_t* starts,
                              const int64_t* ends, int64_t n, int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t days;
        if (ends[i] - starts[i] != 10 || !parse_ymd(bytes + starts[i], &days))
            return i;
        out[i] = static_cast<int32_t>(days);
    }
    return n;
}

// "YYYY-MM-DD hh:mm:ss", "YYYY-MM-DDThh:mm:ss" or "YYYY-MM-DD" -> seconds
int64_t msdb_parse_datetime_spans(const char* bytes, const int64_t* starts,
                                  const int64_t* ends, int64_t n,
                                  int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const char* p = bytes + starts[i];
        int64_t len = ends[i] - starts[i];
        int64_t days, hh = 0, mm = 0, ss = 0;
        if ((len != 10 && len != 19) || !parse_ymd(p, &days)) return i;
        if (len == 19) {
            if ((p[10] != ' ' && p[10] != 'T') || !digits(p + 11, 2, &hh) ||
                p[13] != ':' || !digits(p + 14, 2, &mm) || p[16] != ':' ||
                !digits(p + 17, 2, &ss) || hh > 23 || mm > 59 || ss > 59)
                return i;
        }
        out[i] = days * 86400 + hh * 3600 + mm * 60 + ss;
    }
    return n;
}

// dictionary encoding of spans; starts[i] < 0 is a NULL (id -1)
void* msdb_dict_encode_spans(const char* bytes, const int64_t* starts,
                             const int64_t* ends, int64_t n) {
    auto* res = new EncodeResult();
    res->ids.resize(static_cast<size_t>(n));
    res->uniq_offsets.push_back(0);
    std::unordered_map<std::string_view, int32_t> map;
    map.reserve(1024);
    std::vector<int64_t> firsts;         // a first occurrence's start
    for (int64_t i = 0; i < n; ++i) {
        if (starts[i] < 0) { res->ids[static_cast<size_t>(i)] = -1; continue; }
        std::string_view sv(bytes + starts[i],
                            static_cast<size_t>(ends[i] - starts[i]));
        auto it = map.find(sv);
        if (it != map.end()) {
            res->ids[static_cast<size_t>(i)] = it->second;
            continue;
        }
        int32_t id = static_cast<int32_t>(map.size());
        map.emplace(sv, id);
        res->uniq_bytes.append(sv);
        res->uniq_offsets.push_back(
            static_cast<int64_t>(res->uniq_bytes.size()));
        res->ids[static_cast<size_t>(i)] = id;
    }
    return res;
}

// Split a CSV/TSV buffer into fields as Python's csv.reader does with its
// default dialect (quotechar '"', doubled quotes, strict=False) over a file
// opened with newline='': lines end at \n, \r\n or \r; a quoted field may
// span lines.  Unescaped field bytes go to out; field f is
// out[field_offs[f], field_offs[f + 1]); record r holds the fields
// rec_first[r] .. rec_first[r + 1] - 1 (a blank line is a record of none).
// Returns the record count, or -1 when a capacity is too small.
int64_t msdb_csv_split(const char* buf, int64_t len, char delim, char* out,
                       int64_t* field_offs, int64_t field_cap,
                       int64_t* rec_first, int64_t rec_cap) {
    enum { START_RECORD, START_FIELD, IN_FIELD, IN_QUOTED, QUOTE_IN_QUOTED,
           EAT_CRNL };
    int state = START_RECORD;
    int64_t op = 0, nf = 0, nr = 0;
    field_offs[0] = 0;
    auto save = [&]() -> bool {
        if (nf + 1 >= field_cap) return false;
        field_offs[++nf] = op;
        return true;
    };
    int64_t i = 0;
    bool in_record = false;
    while (i < len) {
        // one line: up to and including its terminator
        int64_t e = i;
        while (e < len && buf[e] != '\n' && buf[e] != '\r') ++e;
        if (e < len) {
            if (buf[e] == '\r' && e + 1 < len && buf[e + 1] == '\n') e += 2;
            else e += 1;
        }
        for (int64_t k = i; k <= e; ++k) {
            bool eol = (k == e);
            char c = eol ? 0 : buf[k];
            bool nl = !eol && (c == '\n' || c == '\r');
            if (state == START_RECORD) {
                if (!in_record) {
                    if (nr + 1 >= rec_cap) return -1;
                    rec_first[nr] = nf;
                    in_record = true;
                }
                if (eol) {           // a blank line: a record of no fields
                    ++nr; in_record = false;
                    continue;
                }
                if (nl) { state = EAT_CRNL; continue; }
                state = START_FIELD;
            }
            switch (state) {
            case START_FIELD:
                if (eol || nl) {
                    if (!save()) return -1;
                    state = eol ? START_RECORD : EAT_CRNL;
                } else if (c == '"') {
                    state = IN_QUOTED;
                } else if (c == delim) {
                    if (!save()) return -1;
                } else {
                    out[op++] = c;
                    state = IN_FIELD;
                }
                break;
            case IN_FIELD:
                if (eol || nl) {
                    if (!save()) return -1;
                    state = eol ? START_RECORD : EAT_CRNL;
                } else if (c == delim) {
                    if (!save()) return -1;
                    state = START_FIELD;
                } else {
                    out[op++] = c;
                }
                break;
            case IN_QUOTED:
                if (eol) break;      // the field goes on on the next line
                if (c == '"') state = QUOTE_IN_QUOTED;
                else out[op++] = c;
                break;
            case QUOTE_IN_QUOTED:
                if (!eol && c == '"') {
                    out[op++] = '"';
                    state = IN_QUOTED;
                } else if (!eol && c == delim) {
                    if (!save()) return -1;
                    state = START_FIELD;
                } else if (eol || nl) {
                    if (!save()) return -1;
                    state = eol ? START_RECORD : EAT_CRNL;
                } else {
                    out[op++] = c;
                    state = IN_FIELD;
                }
                break;
            case EAT_CRNL:
                if (eol) state = START_RECORD;
                break;
            }
            if (eol && state == START_RECORD && in_record) {
                ++nr;
                in_record = false;
            }
        }
        i = e;
    }
    if (in_record) {                 // the data ended inside a field
        if (state != START_RECORD && state != EAT_CRNL)
            if (!save()) return -1;
        ++nr;
    }
    rec_first[nr] = nf;
    return nr;
}

// Row assembly for the row formats' writers.  Column c contributes, per
// row: its lead text, then either its null text (where valid[c] says NULL,
// or a dictionary id is -1) or pre + value + post.  Value kinds:
enum { FK_I64 = 0, FK_U64 = 1, FK_DICT = 2, FK_BLOB = 3, FK_DATE = 4,
       FK_DATETIME = 5, FK_RAW = 6 };
// FK_I64/FK_U64: decimal of int64/uint64 data; FK_DICT: the blob entry of
// the row's int32 id; FK_BLOB: the row's own blob entry; FK_DATE (int32
// days) "YYYY-MM-DD"; FK_DATETIME (int64 seconds) "YYYY-MM-DD hh:mm:ss";
// FK_RAW: widths[c] bytes of data.  texts holds 4 strings per column (lead,
// pre, post, null) and then the row terminator, at text_offs.  With out
// null only the size is computed.  Returns the bytes of rows [r0, r1), or
// -1 for a date outside years 1-9999.

static int digits10(uint64_t v) {
    int k = 1;
    while (v >= 10) { v /= 10; ++k; }
    return k;
}

static int put_u64(uint64_t v, char* out) {
    int k = digits10(v);
    if (out)
        for (int j = k - 1; j >= 0; --j) {
            out[j] = static_cast<char>('0' + v % 10);
            v /= 10;
        }
    return k;
}

static void put2(int64_t v, char* out) {
    out[0] = static_cast<char>('0' + v / 10);
    out[1] = static_cast<char>('0' + v % 10);
}

static int put_date(int64_t days, char* out) {
    int64_t y, m, d;
    civil_from_days(days, &y, &m, &d);
    if (y < 1 || y > 9999) return -1;
    if (out) {
        put2(y / 100, out);
        put2(y % 100, out + 2);
        out[4] = '-';
        put2(m, out + 5);
        out[7] = '-';
        put2(d, out + 8);
    }
    return 10;
}

static int put_datetime(int64_t secs, char* out) {
    int64_t days = secs >= 0 ? secs / 86400 : -((-secs + 86399) / 86400);
    int64_t rem = secs - days * 86400;
    if (put_date(days, out) < 0) return -1;
    if (out) {
        out[10] = ' ';
        put2(rem / 3600, out + 11);
        out[13] = ':';
        put2(rem / 60 % 60, out + 14);
        out[16] = ':';
        put2(rem % 60, out + 17);
    }
    return 19;
}

int64_t msdb_format_rows(int64_t r0, int64_t r1, int64_t ncols,
                         const int32_t* kinds, const void* const* data,
                         const int64_t* widths, const char* const* blobs,
                         const int64_t* const* blob_offs,
                         const uint8_t* const* valid, const char* texts,
                         const int64_t* text_offs, char* out) {
    int64_t op = 0;
    auto put = [&](const char* s, int64_t n) {
        if (out) std::memcpy(out + op, s, static_cast<size_t>(n));
        op += n;
    };
    auto text = [&](int64_t j) {
        int64_t n = text_offs[j + 1] - text_offs[j];
        if (n) put(texts + text_offs[j], n);
    };
    for (int64_t r = r0; r < r1; ++r) {
        for (int64_t c = 0; c < ncols; ++c) {
            text(4 * c);
            int k = kinds[c];
            bool null = valid[c] && !valid[c][r];
            int32_t id = 0;
            if (k == FK_DICT) {
                id = static_cast<const int32_t*>(data[c])[r];
                null = null || id < 0;
            }
            if (null) { text(4 * c + 3); continue; }
            text(4 * c + 1);
            char* dst = out ? out + op : nullptr;
            switch (k) {
            case FK_I64: {
                int64_t v = static_cast<const int64_t*>(data[c])[r];
                if (v < 0) {
                    if (dst) *dst++ = '-';
                    op += 1;
                    op += put_u64(0 - static_cast<uint64_t>(v), dst);
                } else {
                    op += put_u64(static_cast<uint64_t>(v), dst);
                }
                break;
            }
            case FK_U64:
                op += put_u64(static_cast<const uint64_t*>(data[c])[r], dst);
                break;
            case FK_DICT:
                put(blobs[c] + blob_offs[c][id],
                    blob_offs[c][id + 1] - blob_offs[c][id]);
                break;
            case FK_BLOB:
                put(blobs[c] + blob_offs[c][r],
                    blob_offs[c][r + 1] - blob_offs[c][r]);
                break;
            case FK_DATE: {
                int n = put_date(static_cast<const int32_t*>(data[c])[r], dst);
                if (n < 0) return -1;
                op += n;
                break;
            }
            case FK_DATETIME: {
                int n = put_datetime(static_cast<const int64_t*>(data[c])[r],
                                     dst);
                if (n < 0) return -1;
                op += n;
                break;
            }
            case FK_RAW:
                put(static_cast<const char*>(data[c]) + r * widths[c],
                    widths[c]);
                break;
            }
            text(4 * c + 2);
        }
        text(4 * ncols);
    }
    return op;
}

// RowBinary rows: column c is widths[c] little-endian bytes, or (width 0) a
// varint length and that many bytes; a nullable column's value follows a
// byte that is 1 for NULL (and then no value).  With max_rows < 0 the rows
// are only counted.  Else fixed columns are copied to fixed_out[c] (zeros
// for NULL), strings give their spans (str_start/str_end, -1 for NULL)
// and nullable columns their null bytes.  Returns the row count, or -1
// for data that ends inside a row.
int64_t msdb_rowbinary_scan(const uint8_t* buf, int64_t len, int64_t pos,
                            int64_t ncols, const int64_t* widths,
                            const uint8_t* nullable, int64_t max_rows,
                            uint8_t* const* fixed_out,
                            int64_t* const* str_start,
                            int64_t* const* str_end,
                            uint8_t* const* null_out) {
    int64_t r = 0;
    bool fill = max_rows >= 0;
    while (pos < len) {
        if (fill && r >= max_rows) return -1;
        for (int64_t c = 0; c < ncols; ++c) {
            bool isnull = false;
            if (nullable[c]) {
                if (pos >= len) return -1;
                isnull = buf[pos++] != 0;
                if (fill) null_out[c][r] = isnull ? 1 : 0;
            }
            int64_t w = widths[c];
            if (isnull) {
                if (fill) {
                    if (w) std::memset(fixed_out[c] + r * w, 0,
                                       static_cast<size_t>(w));
                    else { str_start[c][r] = -1; str_end[c][r] = -1; }
                }
                continue;
            }
            if (w) {
                if (pos + w > len) return -1;
                if (fill) std::memcpy(fixed_out[c] + r * w, buf + pos,
                                      static_cast<size_t>(w));
                pos += w;
                continue;
            }
            uint64_t n = 0;
            int shift = 0;
            while (true) {
                if (pos >= len || shift > 63) return -1;
                uint8_t b = buf[pos++];
                n |= static_cast<uint64_t>(b & 0x7F) << shift;
                if (!(b & 0x80)) break;
                shift += 7;
            }
            if (n > static_cast<uint64_t>(len - pos)) return -1;
            if (fill) {
                str_start[c][r] = pos;
                str_end[c][r] = pos + static_cast<int64_t>(n);
            }
            pos += static_cast<int64_t>(n);
        }
        ++r;
    }
    return r;
}

// JSONEachRow: one JSON object per line (lines end at \n, \r\n or \r; blank
// lines are skipped).  For each row and each wanted column (names at
// name_offs), the cell's kind: 0 missing, 1 null, 2 an integer (its
// text), 3 string (unescaped, UTF-8), 4 true, 5 false, 6 an array or object
// (its text), 7 another number (a fraction, an exponent, NaN or
// Infinity: its text); the text lies at out[cell_start, cell_end).  Keys not wanted are
// skipped; of repeated keys the last counts, as in Python's json.  Returns
// the row count, or -1 - (the line index) for a line this scanner does not
// take (not an object, invalid JSON, a lone surrogate, control bytes in a
// string), which the caller leaves to Python's json module.
namespace {
struct JsonScan {
    const char* p;
    const char* end;
    char* out;
    int64_t op;
    void ws() { while (p < end && (*p == ' ' || *p == '\t')) ++p; }
    static int hex4(const char* q) {
        int v = 0;
        for (int j = 0; j < 4; ++j) {
            char c = q[j];
            v <<= 4;
            if (c >= '0' && c <= '9') v |= c - '0';
            else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
            else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
            else return -1;
        }
        return v;
    }
    void emit(char c) { out[op++] = c; }
    void utf8(uint32_t cp) {
        if (cp < 0x80) emit(static_cast<char>(cp));
        else if (cp < 0x800) {
            emit(static_cast<char>(0xC0 | (cp >> 6)));
            emit(static_cast<char>(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
            emit(static_cast<char>(0xE0 | (cp >> 12)));
            emit(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
            emit(static_cast<char>(0x80 | (cp & 0x3F)));
        } else {
            emit(static_cast<char>(0xF0 | (cp >> 18)));
            emit(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
            emit(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
            emit(static_cast<char>(0x80 | (cp & 0x3F)));
        }
    }
    // a string at p ('"'): unescaped into out
    bool str() {
        if (p >= end || *p != '"') return false;
        ++p;
        while (p < end) {
            unsigned char c = static_cast<unsigned char>(*p);
            if (c == '"') { ++p; return true; }
            if (c < 0x20) return false;
            if (c != '\\') { emit(static_cast<char>(c)); ++p; continue; }
            if (p + 1 >= end) return false;
            char e = p[1];
            p += 2;
            switch (e) {
            case '"': emit('"'); break;
            case '\\': emit('\\'); break;
            case '/': emit('/'); break;
            case 'b': emit('\b'); break;
            case 'f': emit('\f'); break;
            case 'n': emit('\n'); break;
            case 'r': emit('\r'); break;
            case 't': emit('\t'); break;
            case 'u': {
                if (end - p < 4) return false;
                int v = hex4(p);
                if (v < 0) return false;
                p += 4;
                uint32_t cp = static_cast<uint32_t>(v);
                if (cp >= 0xDC00 && cp <= 0xDFFF) return false;
                if (cp >= 0xD800 && cp <= 0xDBFF) {
                    if (end - p < 6 || p[0] != '\\' || p[1] != 'u') return false;
                    int lo = hex4(p + 2);
                    if (lo < 0xDC00 || lo > 0xDFFF) return false;
                    p += 6;
                    cp = 0x10000 + ((cp - 0xD800) << 10) +
                         (static_cast<uint32_t>(lo) - 0xDC00);
                }
                utf8(cp);
                break;
            }
            default: return false;
            }
        }
        return false;
    }
    bool lit(const char* w) {
        size_t n = std::strlen(w);
        if (static_cast<size_t>(end - p) < n || std::memcmp(p, w, n)) return false;
        p += n;
        return true;
    }
    // a number (JSON grammar, or Python's NaN / Infinity / -Infinity);
    // floaty: it has a fraction or an exponent, or is NaN / Infinity
    bool floaty = false;
    bool num() {
        const char* s = p;
        floaty = true;
        if (lit("NaN") || lit("Infinity") || lit("-Infinity")) {
            std::memcpy(out + op, s, static_cast<size_t>(p - s));
            op += p - s;
            return true;
        }
        floaty = false;
        if (p < end && *p == '-') ++p;
        if (p >= end) return false;
        if (*p == '0') ++p;
        else if (*p >= '1' && *p <= '9') { while (p < end && *p >= '0' && *p <= '9') ++p; }
        else return false;
        if (p < end && *p == '.') {
            floaty = true;
            ++p;
            if (p >= end || *p < '0' || *p > '9') return false;
            while (p < end && *p >= '0' && *p <= '9') ++p;
        }
        if (p < end && (*p == 'e' || *p == 'E')) {
            floaty = true;
            ++p;
            if (p < end && (*p == '+' || *p == '-')) ++p;
            if (p >= end || *p < '0' || *p > '9') return false;
            while (p < end && *p >= '0' && *p <= '9') ++p;
        }
        std::memcpy(out + op, s, static_cast<size_t>(p - s));
        op += p - s;
        return true;
    }
    // an array or object: its text, checked only for balance and strings
    bool nested() {
        const char* s = p;
        int depth = 0;
        while (p < end) {
            char c = *p;
            if (c == '"') {
                int64_t save = op;
                if (!str()) return false;
                op = save;
                continue;
            }
            if (c == '[' || c == '{') ++depth;
            else if (c == ']' || c == '}') {
                if (--depth == 0) { ++p; break; }
            }
            ++p;
        }
        if (depth) return false;
        std::memcpy(out + op, s, static_cast<size_t>(p - s));
        op += p - s;
        return true;
    }
};
}  // namespace

int64_t msdb_json_scan(const char* buf, int64_t len, int64_t ncols,
                       const char* names, const int64_t* name_offs,
                       int64_t max_rows, char* out, int64_t* cell_start,
                       int64_t* cell_end, int8_t* cell_kind) {
    std::unordered_map<std::string, int64_t> cols;
    for (int64_t c = 0; c < ncols; ++c)
        cols.emplace(std::string(names + name_offs[c],
                                 static_cast<size_t>(name_offs[c + 1] -
                                                     name_offs[c])), c);
    JsonScan s{nullptr, nullptr, out, 0};
    int64_t rows = 0, line = 0, i = 0;
    std::string key;
    while (i < len) {
        int64_t e = i;
        while (e < len && buf[e] != '\n' && buf[e] != '\r') ++e;
        int64_t next = e;
        if (e < len) next = (buf[e] == '\r' && e + 1 < len && buf[e + 1] == '\n')
                            ? e + 2 : e + 1;
        s.p = buf + i;
        s.end = buf + e;
        int64_t this_line = line++;
        i = next;
        s.ws();
        if (s.p == s.end) continue;               // a blank line
        if (rows >= max_rows) return -1 - this_line;
        int8_t* kinds = cell_kind + rows * ncols;
        std::memset(kinds, 0, static_cast<size_t>(ncols));
        if (*s.p != '{') return -1 - this_line;
        ++s.p;
        s.ws();
        bool first = true;
        while (true) {
            if (s.p < s.end && *s.p == '}') {
                if (!first) return -1 - this_line;   // "{..., }"
                ++s.p;
                break;
            }
            int64_t kstart = s.op;
            if (!s.str()) return -1 - this_line;
            key.assign(out + kstart, static_cast<size_t>(s.op - kstart));
            s.op = kstart;
            s.ws();
            if (s.p >= s.end || *s.p != ':') return -1 - this_line;
            ++s.p;
            s.ws();
            if (s.p >= s.end) return -1 - this_line;
            int64_t vstart = s.op;
            int8_t kind;
            char c = *s.p;
            if (c == '"') { if (!s.str()) return -1 - this_line; kind = 3; }
            else if (c == '[' || c == '{') {
                if (!s.nested()) return -1 - this_line;
                kind = 6;
            } else if (s.lit("null")) kind = 1;
            else if (s.lit("true")) kind = 4;
            else if (s.lit("false")) kind = 5;
            else if (s.num()) kind = s.floaty ? 7 : 2;
            else return -1 - this_line;
            auto it = cols.find(key);
            if (it == cols.end()) {
                s.op = vstart;
            } else {
                int64_t cell = rows * ncols + it->second;
                cell_kind[cell] = kind;
                cell_start[cell] = vstart;
                cell_end[cell] = s.op;
            }
            s.ws();
            first = false;
            if (s.p < s.end && *s.p == ',') {
                ++s.p;
                s.ws();
                if (s.p < s.end && *s.p == '}') return -1 - this_line;
                continue;
            }
            if (s.p < s.end && *s.p == '}') { ++s.p; break; }
            return -1 - this_line;
        }
        s.ws();
        if (s.p != s.end) return -1 - this_line;
        ++rows;
    }
    return rows;
}

}  // extern "C"
