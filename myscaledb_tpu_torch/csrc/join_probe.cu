// join_probe (K7): each probe row's build row through the dense
// direct-lookup table of a join on one integer key, in one pass.
//
// Replaces no TPU kernel: the JAX package probes its dense join table
// with jnp operations, and so did the port (ops/join.py::probe_sorted),
// as a chain of ten element-wise passes over the probe rows (the key
// widened to int64, less lo, two range compares, their and, a clamp, the
// gather, a compare with the absent mark, an and, a where), two int64
// temporaries among them: about 94 B of device traffic a probe row where
// the work needs 9 B.  The Star Schema Benchmark probes 600M lineorder
// rows through that chain several times a statement.  For every row i:
//
//   d = key[i] - lo                 (64-bit, wrapping as int64 arithmetic)
//   row = 0 <= d < m ? lookup[d] : INT32_MAX
//   found = row != INT32_MAX && (no mask || mask[i] != 0)
//   row_out[i] = found ? row : INT32_MAX;  found_out[i] = found
//
// which is what the chain computes, bit for bit (ops/kernels/
// join_probe.py::probe_direct_plain).
//
// Bound on the H100: memory.  Each row reads its key (4 or 8 B) and, with
// a mask, one mask byte, and writes a 4 B row and a 1 B flag: 9 B a row
// for int32 keys, 5.4 GB and 1.61 ms at 600M rows and 3.35 TB/s.  The
// lookup (4 B a key of the build's range, 12 MB for SSB's 3M customers)
// is read at random, once a row, from the 50 MB L2.
//
// Design:
//  - Keys are read 16 bytes a thread (four int32 keys, or four int64 keys
//    in two 16-byte loads) with streaming, evict-first loads; the rows and
//    flags are written with streaming stores (16 and 4 bytes a thread).
//    So the lookup is the only data the pass leaves resident in L2.
//  - The lookup is read through the read-only path (ld.global.nc); a
//    masked-out or out-of-range row reads nothing.
//  - A grid-stride loop over a grid sized to the SMs' occupancy; each
//    thread has UNROLL quads of keys in flight before any lookup.
//  - Columns that do not start on a 16-byte boundary (a view into a
//    larger tensor) take the same loop a row at a time; so do the last
//    n % 4 rows.
//  - The key's width is a template parameter: one algorithm, one entry.
//  - No temporaries: the wrapper allocates the two outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;
constexpr int ABSENT = 0x7fffffff;

// Four keys of one quad, widened to 64 bits.
template <typename K> struct Quad;
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

// The build row of key k (ABSENT where none); `sel` false reads nothing.
__device__ __forceinline__ int lookup_row(long long k, bool sel,
                                          const int* __restrict__ lookup,
                                          unsigned long long lo,
                                          unsigned long long m) {
  // k - lo as int64 wraps; as unsigned, 0 <= d < m is one compare
  const unsigned long long d = (unsigned long long)k - lo;
  return sel && d < m ? __ldg(lookup + d) : ABSENT;
}

template <typename K, bool VEC, bool MASK>
__global__ void __launch_bounds__(THREADS)
join_probe_direct_kernel(const K* __restrict__ key,
                         const int* __restrict__ lookup,
                         unsigned long long lo, unsigned long long m,
                         const unsigned char* __restrict__ mask, long long n,
                         int* __restrict__ row_out,
                         unsigned char* __restrict__ found_out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  long long done = 0;
  if (VEC) {
    const long long nquads = n >> 2;
    for (long long q0 = t; q0 < nquads; q0 += UNROLL * stride) {
      long long k[UNROLL][4] = {};
      bool sel[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long q = q0 + u * stride;
        const bool act = q < nquads;
        if (act) Quad<K>::load(key + 4 * q, k[u]);
        if (MASK && act) {
          const uchar4 mv =
              __ldcs(reinterpret_cast<const uchar4*>(mask) + q);
          sel[u][0] = mv.x; sel[u][1] = mv.y;
          sel[u][2] = mv.z; sel[u][3] = mv.w;
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) sel[u][r] = act;
        }
      }
      int row[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          row[u][r] = lookup_row(k[u][r], sel[u][r], lookup, lo, m);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long q = q0 + u * stride;
        if (q >= nquads) break;
        __stcs(reinterpret_cast<int4*>(row_out) + q,
               make_int4(row[u][0], row[u][1], row[u][2], row[u][3]));
        __stcs(reinterpret_cast<uchar4*>(found_out) + q,
               make_uchar4(row[u][0] != ABSENT, row[u][1] != ABSENT,
                           row[u][2] != ABSENT, row[u][3] != ABSENT));
      }
    }
    done = nquads << 2;
  }
  for (long long i = done + t; i < n; i += stride) {
    const bool sel = !MASK || __ldcs(mask + i);
    const int row = lookup_row((long long)__ldcs(key + i), sel, lookup, lo,
                               m);
    __stcs(row_out + i, row);
    __stcs(found_out + i, (unsigned char)(row != ABSENT));
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename K, bool VEC, bool MASK>
void launch(const void* key, const int* lookup, long long lo, long long m,
            const unsigned char* mask, long long n, int* row_out,
            unsigned char* found_out, cudaStream_t st) {
  auto kernel = join_probe_direct_kernel<K, VEC, MASK>;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  const long long per_block = VEC ? 4LL * UNROLL * THREADS : THREADS;
  const long long need = (n + per_block - 1) / per_block;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const K*>(key), lookup, (unsigned long long)lo,
      (unsigned long long)m, mask, n, row_out, found_out);
}

template <typename K>
void dispatch(bool vec, const void* key, const int* lookup, long long lo,
              long long m, const unsigned char* mask, long long n,
              int* row_out, unsigned char* found_out, cudaStream_t st) {
  if (vec && mask)
    launch<K, true, true>(key, lookup, lo, m, mask, n, row_out, found_out,
                          st);
  else if (vec)
    launch<K, true, false>(key, lookup, lo, m, mask, n, row_out, found_out,
                           st);
  else if (mask)
    launch<K, false, true>(key, lookup, lo, m, mask, n, row_out, found_out,
                           st);
  else
    launch<K, false, false>(key, lookup, lo, m, mask, n, row_out, found_out,
                            st);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace

// key (n,) of key_bytes (4 or 8) signed bytes, lookup (m,) int32 with
// m >= 1, mask (n,) bytes or null, row_out (n,) int32, found_out (n,)
// bytes (0 or 1).  Launches nothing for n == 0.
extern "C" int msdb_join_probe_direct(const void* key, int key_bytes,
                                      const int32_t* lookup, long long lo,
                                      long long m, const uint8_t* mask,
                                      long long n, int32_t* row_out,
                                      uint8_t* found_out, void* stream) {
  if (n < 0 || m < 1 || !(key_bytes == 4 || key_bytes == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = reinterpret_cast<const unsigned char*>(mask);
  unsigned char* fo = reinterpret_cast<unsigned char*>(found_out);
  const bool vec = aligned(key, 16) && aligned(row_out, 16) &&
                   aligned(found_out, 4) && (!mask || aligned(mask, 4));
  if (key_bytes == 4)
    dispatch<int>(vec, key, lookup, lo, m, mk, n, row_out, fo, st);
  else
    dispatch<long long>(vec, key, lookup, lo, m, mk, n, row_out, fo, st);
  return static_cast<int>(cudaGetLastError());
}
