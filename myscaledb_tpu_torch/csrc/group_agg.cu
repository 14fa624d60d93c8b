// group_agg: per group, the count of selected rows, exact int64 sums of
// int32 arguments and f32 sums of f32 arguments, for G <= 256 groups.
//
// Replaces: myscaledb_tpu/ops/pallas/group_agg.py::pallas_group_aggregate
// (Pallas body `_make_kernel`, pallas_call in `_chunk_call`).  A row counts
// when mask[row] != 0 and 0 <= gid[row] < G; other rows are skipped.
//
// Bound on the H100: memory.  Each row is read once: gid (4 B), mask (1 B)
// and 4 B per argument.  BASELINE config 2 (100M rows, one argument) moves
// 0.9 GB, 0.27 ms at 3.35 TB/s; a few integer ops per row stay far below
// the card's rate.
//
// Design (simple first).  The TPU kernel splits ints into 16-bit limbs,
// takes a single-limb path for narrow zone-map ranges and chunks calls at
// 16M rows, all because its vector unit accumulates in int32 only.  Hopper
// accumulates int32 values into int64 directly, so none of that is here
// (the wrapper accepts `arg_ranges` and ignores them).
//
// Each block owns one contiguous stretch of rows; each of its 8 warps keeps
// a private histogram in shared memory: G uint32 counts and, per argument,
// G 8-byte accumulators (int64, or an f32 in the low half).  A warp loads
// 4 x 32 consecutive rows ahead (coalesced), then takes them 32 at a time:
//  - all selected lanes in one group (small G): a fixed xor butterfly sums
//    them and one lane updates the histogram;
//  - otherwise, with no float argument: each lane adds its row with
//    shared-memory integer atomics, exact in any order;
//  - otherwise: __match_any_sync groups the lanes by gid, and the lowest
//    lane of each match set adds its peers' values in lane order (read
//    from a per-warp staging row) and updates the histogram.
// No float atomics anywhere: every float sum
// is taken in an order fixed by the data and the grid, so it is identical
// from run to run (the TPU kernel's promise, group_agg.py:23-26).  At the
// end the block adds its warps' histograms in warp order into one partial
// row per quantity, (nblocks, 1 + na, G); a second kernel adds the blocks'
// partials in block order, one warp per (quantity, group): each lane a
// fixed stride of blocks, then a fixed butterfly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int U = 4;                 // 32-row steps a warp loads ahead
constexpr int STEP = 32 * U;         // rows a warp loads per sweep
constexpr int MAX_ARGS = 8;
constexpr int MAX_G = 256;
constexpr unsigned FULL = 0xffffffffu;

struct ArgPtrs {
  const uint32_t* p[MAX_ARGS];
};

// Bytes of one warp's shared region: na * G accumulators of 8 bytes, then
// G uint32 counts and na x 32 staging words, rounded up to 8 bytes.
__host__ __device__ inline size_t warp_bytes(int na, int G) {
  const size_t b = (size_t)na * G * 8 + ((size_t)G + (size_t)na * 32) * 4;
  return (b + 7) & ~(size_t)7;
}

template <int NA>
__global__ void __launch_bounds__(THREADS)
group_agg_partial(const int32_t* __restrict__ gid,
                  const uint8_t* __restrict__ mask, ArgPtrs args,
                  unsigned float_bits, long long n, int G,
                  long long rows_per_block, long long* __restrict__ part_i,
                  float* __restrict__ part_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t wb = warp_bytes(NA, G);
  for (size_t i = threadIdx.x; i < wb * WARPS / 4; i += THREADS)
    reinterpret_cast<uint32_t*>(smem)[i] = 0u;
  __syncthreads();
  unsigned char* mine = smem + wb * warp;
  long long* acc = reinterpret_cast<long long*>(mine);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(mine + (size_t)NA * G * 8);
  uint32_t* stage = cnt + G;

  const long long start = (long long)blockIdx.x * rows_per_block;
  const long long end = min(n, start + rows_per_block);
  for (long long base = start + (long long)warp * STEP; base < end;
       base += (long long)WARPS * STEP) {
    int key[U];
    uint32_t val[NA > 0 ? NA : 1][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + u * 32 + lane;
      key[u] = -1;
#pragma unroll
      for (int a = 0; a < NA; ++a) val[a][u] = 0u;
      if (row < end) {
        const int g = __ldg(gid + row);
        if (__ldg(mask + row) != 0 && (unsigned)g < (unsigned)G) key[u] = g;
#pragma unroll
        for (int a = 0; a < NA; ++a) val[a][u] = __ldg(args.p[a] + row);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = key[u];
      const unsigned valid = __ballot_sync(FULL, k >= 0);
      if (valid == 0u) continue;                       // warp-uniform
      const int g = __reduce_max_sync(FULL, k);
      if (__reduce_min_sync(FULL, k >= 0 ? k : 0x7fffffff) == g) {
        // one group among the selected lanes: fixed xor butterfly, with
        // unselected lanes adding zero
        const int first = __ffs(valid) - 1;
        const bool writer = lane == first;
        if (writer) cnt[g] += __popc(valid);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          if ((float_bits >> a) & 1u) {
            float s = k >= 0 ? __uint_as_float(val[a][u]) : 0.f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              s += __shfl_xor_sync(FULL, s, off);
            if (writer) *reinterpret_cast<float*>(acc + a * G + g) += s;
          } else {
            long long s = k >= 0 ? (long long)(int32_t)val[a][u] : 0ll;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              s += __shfl_xor_sync(FULL, s, off);
            if (writer) acc[a * G + g] += s;
          }
        }
      } else if (float_bits == 0u) {
        // counts and int sums only: shared-memory atomics, exact in any
        // order
        if (k >= 0) {
          atomicAdd(cnt + k, 1u);
#pragma unroll
          for (int a = 0; a < NA; ++a)
            atomicAdd(reinterpret_cast<unsigned long long*>(acc + a * G + k),
                      (unsigned long long)(long long)(int32_t)val[a][u]);
        }
      } else {
        const unsigned peers = __match_any_sync(FULL, k);
#pragma unroll
        for (int a = 0; a < NA; ++a) stage[a * 32 + lane] = val[a][u];
        __syncwarp();
        if (k >= 0 && lane == __ffs(peers) - 1) {
          cnt[k] += __popc(peers);
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const uint32_t* st = stage + a * 32;
            unsigned m = peers;
            if ((float_bits >> a) & 1u) {
              float s = 0.f;
              while (m) {                               // ascending lanes
                s += __uint_as_float(st[__ffs(m) - 1]);
                m &= m - 1;
              }
              *reinterpret_cast<float*>(acc + a * G + k) += s;
            } else {
              long long s = 0;
              while (m) {
                s += (long long)(int32_t)st[__ffs(m) - 1];
                m &= m - 1;
              }
              acc[a * G + k] += s;
            }
          }
        }
      }
      __syncwarp();   // histogram and staging writes seen by every lane
    }
  }
  __syncthreads();

  // the block's partials: warps added in warp order
  const int rows = 1 + NA;
  for (int i = threadIdx.x; i < rows * G; i += THREADS) {
    const int q = i / G;
    const int g = i - q * G;
    const long long out = ((long long)blockIdx.x * rows + q) * G + g;
    if (q == 0) {
      long long s = 0;
      for (int w = 0; w < WARPS; ++w)
        s += reinterpret_cast<const uint32_t*>(smem + wb * w +
                                               (size_t)NA * G * 8)[g];
      part_i[out] = s;
    } else if ((float_bits >> (q - 1)) & 1u) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w)
        s += *reinterpret_cast<const float*>(
            reinterpret_cast<const long long*>(smem + wb * w) +
            (q - 1) * G + g);
      part_f[((long long)blockIdx.x * NA + (q - 1)) * G + g] = s;
    } else {
      long long s = 0;
      for (int w = 0; w < WARPS; ++w)
        s += reinterpret_cast<const long long*>(smem + wb * w)[(q - 1) * G +
                                                               g];
      part_i[out] = s;
    }
  }
}

// out_i (1 + na, G): counts then int sums; out_f (na, G): float sums.  One
// warp per (quantity, group).
__global__ void __launch_bounds__(THREADS)
group_agg_combine(const long long* __restrict__ part_i,
                  const float* __restrict__ part_f, int nblocks, int na,
                  int G, unsigned float_bits, long long* __restrict__ out_i,
                  float* __restrict__ out_f) {
  const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int rows = 1 + na;
  if (item >= rows * G) return;                       // warp-uniform
  const int q = item / G;
  const int g = item - q * G;
  if (q > 0 && ((float_bits >> (q - 1)) & 1u)) {
    float s = 0.f;
    for (int b = lane; b < nblocks; b += 32)
      s += part_f[((long long)b * na + (q - 1)) * G + g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) out_f[(q - 1) * G + g] = s;
  } else {
    long long s = 0;
    for (int b = lane; b < nblocks; b += 32)
      s += part_i[((long long)b * rows + q) * G + g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) out_i[q * G + g] = s;
  }
}

template <int NA>
cudaError_t launch_partial(const int32_t* gid, const uint8_t* mask,
                           const ArgPtrs& args, unsigned float_bits,
                           long long n, int G, int nblocks,
                           long long rows_per_block, long long* part_i,
                           float* part_f, cudaStream_t st) {
  const size_t smem = warp_bytes(NA, G) * WARPS;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_agg_partial<NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  group_agg_partial<NA><<<nblocks, THREADS, smem, st>>>(
      gid, mask, args, float_bits, n, G, rows_per_block, part_i, part_f);
  return cudaGetLastError();
}

}  // namespace

// gid (n,) int32, mask (n,) bool bytes, arg_ptrs: host array of `na`
// device pointers to (n,) int32/f32 columns (bit a of float_bits set =
// argument a is f32).  part_i (nblocks, 1 + na, G) int64 and part_f
// (nblocks, max(na, 1), G) f32 are scratch; out_i (1 + na, G) int64 gets
// the counts and int sums, out_f (max(na, 1), G) f32 the float sums.
extern "C" int msdb_group_agg(const int32_t* gid, const uint8_t* mask,
                              const void* const* arg_ptrs, int na,
                              unsigned float_bits, long long n, int G,
                              int nblocks, long long rows_per_block,
                              long long* part_i, float* part_f,
                              long long* out_i, float* out_f, void* stream) {
  if (na < 0 || na > MAX_ARGS || G < 1 || G > MAX_G || nblocks < 1 ||
      rows_per_block < 1 || (long long)nblocks * rows_per_block < n)
    return static_cast<int>(cudaErrorInvalidValue);
  ArgPtrs args;
  for (int a = 0; a < MAX_ARGS; ++a)
    args.p[a] = a < na ? static_cast<const uint32_t*>(arg_ptrs[a]) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (na) {
    case 0: e = launch_partial<0>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
    case 1: e = launch_partial<1>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
    case 2: e = launch_partial<2>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
    case 3: e = launch_partial<3>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
    case 4: e = launch_partial<4>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
    case 5: e = launch_partial<5>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
    case 6: e = launch_partial<6>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
    case 7: e = launch_partial<7>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
    default: e = launch_partial<8>(gid, mask, args, float_bits, n, G, nblocks, rows_per_block, part_i, part_f, st); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (1 + na) * G;
  group_agg_combine<<<(items + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      part_i, part_f, nblocks, na, G, float_bits, out_i, out_f);
  return static_cast<int>(cudaGetLastError());
}
