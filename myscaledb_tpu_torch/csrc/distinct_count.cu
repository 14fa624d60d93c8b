// distinct_count (K6): per group, the exact number of distinct keys among
// the selected rows: count(DISTINCT key) ... GROUP BY, through one hash set
// in device memory.
//
// Replaces no TPU kernel: the JAX package counts distinct tuples by
// sorting them (lax.sort over (valid, group, key), then the run starts),
// and the port did the same with three stable torch.sorts and a bincount
// (sql/agg_fns.py::_distinct_first_hit, which sumDistinct, avgDistinct and
// multi-argument counts still take).  A count only needs to know whether a
// (group, key) tuple was seen before, so every selected row inserts its
// tuple into one open-addressing table, and the thread whose insert claims
// a new slot adds one to its group's count.  A row counts when
// mask[row] != 0 and 0 <= gid[row] < G.
//
// Bound on the H100: the input bytes, read once: an 8 B key, a 4 B group
// id and a 1 B mask, 13 B a row, 0.39 ms at 100M rows and 3.35 TB/s.  The
// table adds random accesses on top: one 16-byte load a probe and one
// atomic a new tuple, plus the fill of the table (16 B a slot, written
// once).
//
// Design:
//  - A slot is 16 bytes: the key (widened to 64 bits in registers), then
//    the group in the low half of the second word and a full flag in its
//    high half.  An empty slot holds (EMPTY_KEY, 0): its flag is clear, so
//    no key value is reserved; EMPTY_KEY only makes a torn read visible.
//  - Read before any atomic: a probe loads the slot with one 16-byte
//    L2-only load.  A slot that already holds the tuple costs that load
//    alone.  Skewed keys repeat, so their slots stay in the 50 MB L2; the
//    inputs stream through with the evict-first hint and do not push them
//    out.
//  - An empty slot is claimed with one 16-byte atomicCAS (atom.cas.b128,
//    sm_90) from (EMPTY_KEY, 0) to the tuple.  A slot changes once, from
//    empty to full, in that one atomic, so every probe compares the full
//    (group, key): the count is exact whatever the hash does.  A failed
//    CAS returns the slot's content, which is then compared.  Should the
//    16-byte load ever tear into its two 8-byte halves, a half-written
//    slot shows either a clear flag (the CAS then reads it atomically) or
//    the stale EMPTY_KEY beside a set flag (read again by a CAS that
//    cannot succeed), never a wrong tuple.
//  - Linear probing in a power-of-two table at a load of at most 0.5 (the
//    wrapper sizes it from the row count).  A probe sequence that walks the
//    whole table sets *overflow (only a table forced below that size can).
//  - Four rows a thread, loaded with 16-byte (int8: 4-byte, int16: 8-byte)
//    vector loads where the columns are aligned; the four first probes are
//    issued before any is resolved, so each thread has four table loads in
//    flight.  The grid is persistent: a few blocks an SM walk the rows.
//  - A row equal to the row before it (within a warp's 128 rows) probes
//    nothing: a table sorted by its key, as MergeTree keeps ClickBench's
//    hits by (CounterID, EventDate, UserID), holds each key in runs, and
//    without this every row of a new key's first run would queue a CAS on
//    one slot.
//  - Counts: for G <= SHARED_MAX_G each block keeps G uint32 counters in
//    shared memory and flushes the touched ones at its end, one global
//    atomic each; above that, global atomics.  Either way the new tuples
//    of one group in a warp are added once (__match_any_sync).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int SHARED_MAX_G = 12288;        // 48 KB of uint32 counters
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr unsigned long long EMPTY_KEY = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long FLAG = 1ull << 32;

__device__ __forceinline__ ulonglong2 cas128(ulonglong2* slot,
                                             unsigned long long cmp_lo,
                                             unsigned long long cmp_hi,
                                             unsigned long long val_lo,
                                             unsigned long long val_hi) {
  ulonglong2 old;
  asm volatile(
      "{\n\t"
      ".reg .b128 c, v, o;\n\t"
      "mov.b128 c, {%2, %3};\n\t"
      "mov.b128 v, {%4, %5};\n\t"
      "atom.global.cas.b128 o, [%6], c, v;\n\t"
      "mov.b128 {%0, %1}, o;\n\t"
      "}"
      : "=l"(old.x), "=l"(old.y)
      : "l"(cmp_lo), "l"(cmp_hi), "l"(val_lo), "l"(val_hi), "l"(slot)
      : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long slot_of(unsigned long long k,
                                                      unsigned g) {
  // splitmix64's finaliser over the key and the group
  unsigned long long x = k ^ ((unsigned long long)g * 0xD6E8FEB86659FD93ull);
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

// Insert (k, g), whose first slot `pos` was read as `s`.  True when this
// thread's CAS claimed a new slot.
__device__ __forceinline__ bool insert(ulonglong2* table,
                                       unsigned long long cap_mask,
                                       unsigned long long k, unsigned g,
                                       unsigned long long pos, ulonglong2 s,
                                       int* overflow) {
  const unsigned long long want = (unsigned long long)g | FLAG;
  for (unsigned long long step = 0;;) {
    if (!(s.y & FLAG)) {
      s = cas128(table + pos, EMPTY_KEY, 0ull, k, want);
      if (s.x == EMPTY_KEY && s.y == 0ull) return true;
    } else if (s.x == EMPTY_KEY) {
      // a set flag beside EMPTY_KEY: the tuple's key, or a torn read of a
      // slot being claimed; a CAS that cannot succeed reads it atomically
      s = cas128(table + pos, EMPTY_KEY, 0ull, EMPTY_KEY, 0ull);
    }
    if (s.x == k && s.y == want) return false;
    if (++step > cap_mask) {
      atomicExch(overflow, 1);
      return false;
    }
    pos = (pos + 1) & cap_mask;
    s = __ldcg(table + pos);
  }
}

// Four keys of one quad, sign-extended to 64 bits.
template <typename K> struct Quad;
template <> struct Quad<signed char> {
  static __device__ __forceinline__ void load(const signed char* p,
                                              long long* k) {
    const char4 v = __ldcs(reinterpret_cast<const char4*>(p));
    k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
  }
};
template <> struct Quad<short> {
  static __device__ __forceinline__ void load(const short* p, long long* k) {
    const short4 v = __ldcs(reinterpret_cast<const short4*>(p));
    k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
  }
};
template <> struct Quad<int> {
  static __device__ __forceinline__ void load(const int* p, long long* k) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
  }
};
template <> struct Quad<long long> {
  static __device__ __forceinline__ void load(const long long* p,
                                              long long* k) {
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
    const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
    k[0] = a.x; k[1] = a.y; k[2] = b.x; k[3] = b.y;
  }
};

// New tuples of a warp's step, added once a group: all 32 lanes call it.
template <bool SHARED>
__device__ __forceinline__ void count_new(bool is_new, unsigned g,
                                          unsigned* s_cnt,
                                          unsigned long long* counts) {
  const unsigned news = __ballot_sync(FULL_MASK, is_new);
  if (!is_new) return;
  const unsigned peers = __match_any_sync(news, g);
  if ((int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  if (SHARED)
    atomicAdd(s_cnt + g, (unsigned)__popc(peers));
  else
    atomicAdd(counts + g, (unsigned long long)__popc(peers));
}

template <typename K, bool VEC, bool SHARED>
__global__ void __launch_bounds__(THREADS)
distinct_count_kernel(const int* __restrict__ gid, const K* __restrict__ key,
                      const unsigned char* __restrict__ mask, long long n,
                      int G, ulonglong2* table, unsigned long long cap_mask,
                      unsigned long long* counts, int* overflow) {
  extern __shared__ unsigned s_cnt[];
  if (SHARED) {
    for (int i = threadIdx.x; i < G; i += THREADS) s_cnt[i] = 0u;
    __syncthreads();
  }
  const long long nquads = (n + 3) / 4;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * THREADS) >> 5;
  for (long long base = warp * 32; base < nquads; base += nwarps * 32) {
    const long long q = base + lane;
    const long long row0 = 4 * q;
    long long k[4];
    unsigned g[4];
    bool act[4];
    if (VEC && row0 + 3 < n) {
      Quad<K>::load(key + row0, k);
      const int4 gv = __ldcs(reinterpret_cast<const int4*>(gid + row0));
      const uchar4 mv = __ldcs(reinterpret_cast<const uchar4*>(mask + row0));
      g[0] = gv.x; g[1] = gv.y; g[2] = gv.z; g[3] = gv.w;
      act[0] = mv.x; act[1] = mv.y; act[2] = mv.z; act[3] = mv.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long row = row0 + r;
        act[r] = row < n && __ldcs(mask + row);
        k[r] = act[r] ? (long long)__ldcs(key + row) : 0;
        g[r] = act[r] ? (unsigned)__ldcs(gid + row) : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) act[r] = act[r] && g[r] < (unsigned)G;
    // a selected row equal to the selected row before it holds that
    // row's tuple again: only the first row of such a run probes
    const long long pk = __shfl_up_sync(FULL_MASK, k[3], 1);
    const unsigned pg = __shfl_up_sync(FULL_MASK, g[3], 1);
    const int pa = __shfl_up_sync(FULL_MASK, (int)act[3], 1);
    bool probe[4];
    probe[0] = act[0] && !(lane > 0 && pa && pk == k[0] && pg == g[0]);
#pragma unroll
    for (int r = 1; r < 4; ++r)
      probe[r] = act[r] && !(act[r - 1] && k[r - 1] == k[r] &&
                             g[r - 1] == g[r]);
    unsigned long long pos[4];
    ulonglong2 s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (probe[r]) {
        pos[r] = slot_of((unsigned long long)k[r], g[r]) & cap_mask;
        s[r] = __ldcg(table + pos[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool is_new =
          probe[r] && insert(table, cap_mask, (unsigned long long)k[r], g[r],
                             pos[r], s[r], overflow);
      count_new<SHARED>(is_new, g[r], s_cnt, counts);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < G; i += THREADS)
      if (s_cnt[i]) atomicAdd(counts + i, (unsigned long long)s_cnt[i]);
  }
}

__global__ void fill_empty(ulonglong2* table, long long cap) {
  const ulonglong2 e = make_ulonglong2(EMPTY_KEY, 0ull);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += (long long)gridDim.x * blockDim.x)
    table[i] = e;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename K, bool VEC, bool SHARED>
void launch(const int* gid, const void* key, const unsigned char* mask,
            long long n, int G, ulonglong2* table,
            unsigned long long cap_mask, unsigned long long* counts,
            int* overflow, cudaStream_t st) {
  auto kernel = distinct_count_kernel<K, VEC, SHARED>;
  const size_t smem = SHARED ? (size_t)G * sizeof(unsigned) : 0;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                smem);
  const long long nquads = (n + 3) / 4;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  const long long need = (nquads + THREADS - 1) / THREADS;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, THREADS, smem, st>>>(
      gid, static_cast<const K*>(key), mask, n, G, table, cap_mask, counts,
      overflow);
}

template <typename K>
void dispatch(bool vec, bool shared, const int* gid, const void* key,
              const unsigned char* mask, long long n, int G,
              ulonglong2* table, unsigned long long cap_mask,
              unsigned long long* counts, int* overflow, cudaStream_t st) {
  if (vec && shared)
    launch<K, true, true>(gid, key, mask, n, G, table, cap_mask, counts,
                          overflow, st);
  else if (vec)
    launch<K, true, false>(gid, key, mask, n, G, table, cap_mask, counts,
                           overflow, st);
  else if (shared)
    launch<K, false, true>(gid, key, mask, n, G, table, cap_mask, counts,
                           overflow, st);
  else
    launch<K, false, false>(gid, key, mask, n, G, table, cap_mask, counts,
                            overflow, st);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// gid (n,) int32, key (n,) of key_bytes (1, 2, 4 or 8) signed bytes, mask
// (n,) bytes, table (capacity, 2) int64 with capacity a power of two,
// counts (G,) int64 and overflow (1,) int32: both zeroed here, the table
// filled here.
extern "C" int msdb_distinct_count(const int32_t* gid, const void* key,
                                   int key_bytes, const uint8_t* mask,
                                   long long n, int G, void* table,
                                   long long capacity, long long* counts,
                                   int* overflow, void* stream) {
  if (n < 0 || G < 1 || capacity < 2 || (capacity & (capacity - 1)) ||
      !(key_bytes == 1 || key_bytes == 2 || key_bytes == 4 || key_bytes == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ulonglong2* tab = static_cast<ulonglong2*>(table);
  unsigned long long* cnt = reinterpret_cast<unsigned long long*>(counts);
  cudaMemsetAsync(counts, 0, (size_t)G * sizeof(long long), st);
  cudaMemsetAsync(overflow, 0, sizeof(int), st);
  const long long fill_need = (capacity + 255) / 256;
  const long long fill_blocks =
      fill_need < 16LL * sm_count() ? fill_need : 16LL * sm_count();
  fill_empty<<<(unsigned)fill_blocks, 256, 0, st>>>(tab, capacity);
  if (n > 0) {
    const bool vec = aligned(key, key_bytes == 8 ? 16 : 4 * key_bytes) &&
                     aligned(gid, 16) && aligned(mask, 4);
    const bool shared = G <= SHARED_MAX_G;
    const unsigned long long cap_mask = (unsigned long long)capacity - 1;
    const int* g = reinterpret_cast<const int*>(gid);
    const unsigned char* m = reinterpret_cast<const unsigned char*>(mask);
    switch (key_bytes) {
      case 1:
        dispatch<signed char>(vec, shared, g, key, m, n, G, tab, cap_mask,
                              cnt, overflow, st);
        break;
      case 2:
        dispatch<short>(vec, shared, g, key, m, n, G, tab, cap_mask, cnt,
                        overflow, st);
        break;
      case 4:
        dispatch<int>(vec, shared, g, key, m, n, G, tab, cap_mask, cnt,
                      overflow, st);
        break;
      default:
        dispatch<long long>(vec, shared, g, key, m, n, G, tab, cap_mask, cnt,
                            overflow, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
