// group_agg: per group, the count of selected rows, exact int64 sums of
// int32 arguments, f32 sums of f32 arguments, and the min and max of int32
// or int64 arguments, for G <= 256 groups.
//
// Replaces: myscaledb_tpu/ops/pallas/group_agg.py::pallas_group_aggregate
// (Pallas body `_make_kernel`, pallas_call in `_chunk_call`), which takes
// counts and sums; the min/max lanes replace the scatter reductions of
// myscaledb_tpu/ops/aggregate.py::partial_aggregate for G <= 256.  A row
// counts when mask[row] != 0 and 0 <= gid[row] < G; other rows are skipped.
//
// Bound on the H100: memory.  Each row is read once: gid (4 B), mask (1 B)
// and 4 or 8 B per argument, however many lanes read it.  BASELINE config 2
// (100M rows, one argument) moves 0.9 GB, 0.27 ms at 3.35 TB/s; so does a
// global min and max of one int32 column.  A few integer ops per row stay
// far below the card's rate.
//
// Design (simple first).  The TPU kernel splits ints into 16-bit limbs,
// takes a single-limb path for narrow zone-map ranges and chunks calls at
// 16M rows, all because its vector unit accumulates in int32 only.  Hopper
// accumulates int32 values into int64 directly, so none of that is here
// (the wrapper accepts `arg_ranges` and ignores them).
//
// A launch takes up to 8 lanes (quantities besides the count: an
// argument's sum, min or max) over up to 8 arguments; an argument is
// loaded once per row for all its lanes.  Each block owns one contiguous
// stretch of rows; each of its 8 warps keeps a private histogram in shared
// memory: G uint32 counts and, per lane, G 8-byte accumulators (int64, or
// an f32 or int32 in the low half).  A warp loads 4 x 32 consecutive rows
// ahead (coalesced), then takes them 32 at a time.  Counts and sums:
//  - all selected lanes in one group (small G): a fixed xor butterfly sums
//    them and one lane updates the histogram;
//  - otherwise, with no float argument: each lane adds its row with
//    shared-memory integer atomics, exact in any order;
//  - otherwise: __match_any_sync groups the lanes by gid, and the lowest
//    lane of each match set adds its peers' values in lane order (read
//    from a per-warp staging row) and updates the histogram.
// No float atomics anywhere: every float sum is taken in an order fixed by
// the data and the grid, so it is identical from run to run (the TPU
// kernel's promise, group_agg.py:23-26).
//
// Min and max lanes are a template parameter (MM): a launch without them
// compiles to the count/sum code above alone.  With them, the exact
// quantities (count, int sums, mins, maxes) run in each lane's registers
// for the group of its last row and go into the histogram by shared-memory
// integer atomics, exact in any order, when a row of another group comes:
// at G = 1 once a lane, not once a row; float sums keep the steps above.
// On the H100, 100M rows: a min and a max of one int32 column at G = 1
// took 0.552 ms with the count in the steps above and 0.41 in registers;
// config 2's counts and sums took 0.566 ms in registers against 0.404.
//
// At the end the block reduces its warps' histograms in warp order into
// one partial row per quantity, (nblocks, 1 + lanes, G); a second kernel
// reduces the blocks' partials in block order, one warp per (quantity,
// group): each lane a fixed stride of blocks, then a fixed butterfly.  A
// min/max starts at its storage type's largest / smallest value, so a group
// with no row gives the value the scatter reductions give.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int U = 4;                 // 32-row steps a warp loads ahead
constexpr int STEP = 32 * U;         // rows a warp loads per sweep
constexpr int MAX_ARGS = 8;
constexpr int MAX_LANES = 8;         // quantities besides the count
constexpr int MAX_G = 256;
constexpr unsigned FULL = 0xffffffffu;

// The lanes of a launch.  Lane l is quantity l + 1 of the partials and the
// output; each argument has at most one lane of each kind.
struct Lanes {
  const void* p[MAX_ARGS];     // argument columns, (n,) each
  unsigned float_bits;         // argument a is f32
  unsigned wide_bits;          // argument a is int64 (else int32)
  signed char sum[MAX_ARGS];   // lane of argument a's sum, -1: none
  signed char lo[MAX_ARGS];    // lane of its min, -1: none
  signed char hi[MAX_ARGS];    // lane of its max, -1: none
  unsigned fsum_bits;          // lane l is an f32 sum
  unsigned min_bits;           // lane l is a min
  unsigned max_bits;           // lane l is a max
  unsigned wide_lane_bits;     // lane l is a min/max of an int64 argument
  long long init[MAX_LANES];   // a min/max lane's start value
};

// Bytes of one warp's shared region: nacc * G accumulators of 8 bytes,
// then G uint32 counts and nstage x 32 staging words, rounded up to 8 bytes.
__host__ __device__ inline size_t warp_bytes(int nacc, int nstage, int G) {
  const size_t b = (size_t)nacc * G * 8 +
                   ((size_t)G + (size_t)nstage * 32) * 4;
  return (b + 7) & ~(size_t)7;
}

__device__ __forceinline__ long long minmax(long long a, long long b,
                                            bool lo) {
  return lo ? (b < a ? b : a) : (b > a ? b : a);
}

// The value a lane holds of one argument's row, and the type of a min/max
// lane's registers: 32 bits where every argument has 4 bytes (int32 or f32
// bits), 64 where one is int64 (WIDE).  32 bits keep the loop in fewer
// registers.
template <bool WIDE> struct Val;
template <> struct Val<false> {
  using T = uint32_t;
  using R = int;
  static constexpr int lo = INT_MIN, hi = INT_MAX;
};
template <> struct Val<true> {
  using T = long long;                 // int32 and f32 bits sign-extended
  using R = long long;
  static constexpr long long lo = LLONG_MIN, hi = LLONG_MAX;
};

// NA arguments.  MM: the launch has min/max lanes (and then may have an
// argument with no sum, and int64 arguments where WIDE); without MM, lane
// a is argument a's sum and the min/max code is compiled out.
template <int NA, bool MM, bool WIDE>
__global__ void __launch_bounds__(THREADS)
group_agg_partial(const int32_t* __restrict__ gid,
                  const uint8_t* __restrict__ mask, Lanes ln, int nl,
                  long long n, int G, long long rows_per_block,
                  long long* __restrict__ part_i,
                  float* __restrict__ part_f) {
  static_assert(MM || !WIDE, "int64 arguments come with min/max lanes");
  constexpr int NR = NA > 0 ? NA : 1;   // register arrays' length
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nacc = MM ? nl : NA;        // accumulator rows of a histogram
  const size_t wb = warp_bytes(nacc, NA, G);
  const unsigned float_bits = ln.float_bits;
  if constexpr (MM) {
    const unsigned mm_bits = ln.min_bits | ln.max_bits;
    const int na = nacc * G;
    for (int i = threadIdx.x; i < WARPS * na; i += THREADS) {
      const int w = i / na;
      const int r = i - w * na;
      const int l = r / G;
      reinterpret_cast<long long*>(smem + wb * w)[r] =
          ((mm_bits >> l) & 1u) ? ln.init[l] : 0ll;
    }
    const int rest = (int)((wb - (size_t)na * 8) / 4);  // counts, staging
    for (int i = threadIdx.x; i < WARPS * rest; i += THREADS) {
      const int w = i / rest;
      reinterpret_cast<uint32_t*>(smem + wb * w + (size_t)na * 8)
          [i - w * rest] = 0u;
    }
  } else {
    for (size_t i = threadIdx.x; i < wb * WARPS / 4; i += THREADS)
      reinterpret_cast<uint32_t*>(smem)[i] = 0u;
  }
  __syncthreads();
  unsigned char* mine = smem + wb * warp;
  long long* acc = reinterpret_cast<long long*>(mine);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(mine + (size_t)nacc * G * 8);
  uint32_t* stage = cnt + G;

  // With MM the exact quantities (count, int sums, mins, maxes) run in
  // registers: each lane keeps those of the rows of group `run` it took
  // since its last flush, and flushes them into the warp's histogram with
  // shared-memory atomics when a row of another group comes, and at the
  // end.  At G = 1 that is one flush a lane.
  using V = typename Val<WIDE>::T;
  using R = typename Val<WIDE>::R;
  int run = -1;
  uint32_t run_cnt = 0u;
  long long run_sum[NR];
  R run_lo[NR], run_hi[NR];
  auto flush = [&]() {
    if (run < 0) return;
    atomicAdd(cnt + run, run_cnt);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const bool wide = WIDE && ((ln.wide_bits >> a) & 1u);
      if (ln.sum[a] >= 0 && !((ln.float_bits >> a) & 1u))
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      acc + ln.sum[a] * G + run),
                  (unsigned long long)run_sum[a]);
      if (ln.lo[a] >= 0) {
        long long* m = acc + ln.lo[a] * G + run;
        if (wide) atomicMin(m, (long long)run_lo[a]);
        else atomicMin(reinterpret_cast<int*>(m), (int)run_lo[a]);
      }
      if (ln.hi[a] >= 0) {
        long long* m = acc + ln.hi[a] * G + run;
        if (wide) atomicMax(m, (long long)run_hi[a]);
        else atomicMax(reinterpret_cast<int*>(m), (int)run_hi[a]);
      }
    }
  };

  const long long start = (long long)blockIdx.x * rows_per_block;
  const long long end = min(n, start + rows_per_block);
  for (long long base = start + (long long)warp * STEP; base < end;
       base += (long long)WARPS * STEP) {
    int key[U];
    V val[NR][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + u * 32 + lane;
      key[u] = -1;
#pragma unroll
      for (int a = 0; a < NA; ++a) val[a][u] = 0;
      if (row < end) {
        const int g = __ldg(gid + row);
        if (__ldg(mask + row) != 0 && (unsigned)g < (unsigned)G) key[u] = g;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          if (WIDE && ((ln.wide_bits >> a) & 1u))
            val[a][u] = (V)__ldg(static_cast<const long long*>(ln.p[a]) +
                                 row);
          else if (WIDE)
            val[a][u] = (V)__ldg(static_cast<const int32_t*>(ln.p[a]) + row);
          else
            val[a][u] = __ldg(static_cast<const uint32_t*>(ln.p[a]) + row);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = key[u];
      if constexpr (MM) {
        if (k >= 0) {
          if (k != run) {
            flush();
            run = k;
            run_cnt = 0u;
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              run_sum[a] = 0;
              run_lo[a] = Val<WIDE>::hi;
              run_hi[a] = Val<WIDE>::lo;
            }
          }
          ++run_cnt;
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const R x = (R)val[a][u];
            if (ln.sum[a] >= 0) run_sum[a] += (int32_t)val[a][u];
            if (ln.lo[a] >= 0) run_lo[a] = min(run_lo[a], x);
            if (ln.hi[a] >= 0) run_hi[a] = max(run_hi[a], x);
          }
        }
        if (ln.fsum_bits == 0u) continue;              // warp-uniform
      }
      // counts and sums, or with MM float sums alone (argument a's sum is
      // lane sl, a without MM)
      const unsigned valid = __ballot_sync(FULL, k >= 0);
      if (valid == 0u) continue;                       // warp-uniform
      const int g = __reduce_max_sync(FULL, k);
      if (__reduce_min_sync(FULL, k >= 0 ? k : 0x7fffffff) == g) {
        // one group among the selected lanes: fixed xor butterfly, with
        // unselected lanes adding zero
        const int first = __ffs(valid) - 1;
        const bool writer = lane == first;
        if (!MM && writer) cnt[g] += __popc(valid);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const int sl = MM ? ln.sum[a] : a;
          if (MM && (sl < 0 || !((float_bits >> a) & 1u))) continue;
          if ((float_bits >> a) & 1u) {
            float s = k >= 0 ? __uint_as_float((uint32_t)val[a][u]) : 0.f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              s += __shfl_xor_sync(FULL, s, off);
            if (writer) *reinterpret_cast<float*>(acc + sl * G + g) += s;
          } else {
            long long s = k >= 0 ? (long long)(int32_t)val[a][u] : 0ll;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              s += __shfl_xor_sync(FULL, s, off);
            if (writer) acc[sl * G + g] += s;
          }
        }
      } else if (!MM && float_bits == 0u) {
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
        for (int a = 0; a < NA; ++a)
          stage[a * 32 + lane] = (uint32_t)val[a][u];
        __syncwarp();
        if (k >= 0 && lane == __ffs(peers) - 1) {
          if (!MM) cnt[k] += __popc(peers);
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const int sl = MM ? ln.sum[a] : a;
            if (MM && (sl < 0 || !((float_bits >> a) & 1u))) continue;
            const uint32_t* st = stage + a * 32;
            unsigned m = peers;
            if ((float_bits >> a) & 1u) {
              float s = 0.f;
              while (m) {                               // ascending lanes
                s += __uint_as_float(st[__ffs(m) - 1]);
                m &= m - 1;
              }
              *reinterpret_cast<float*>(acc + sl * G + k) += s;
            } else {
              long long s = 0;
              while (m) {
                s += (long long)(int32_t)st[__ffs(m) - 1];
                m &= m - 1;
              }
              acc[sl * G + k] += s;
            }
          }
        }
      }
      __syncwarp();   // histogram and staging writes seen by every lane
    }
  }
  if constexpr (MM) flush();
  __syncthreads();

  // the block's partials: warps reduced in warp order
  const int rows = 1 + nacc;
  for (int i = threadIdx.x; i < rows * G; i += THREADS) {
    const int q = i / G;
    const int g = i - q * G;
    const long long out = ((long long)blockIdx.x * rows + q) * G + g;
    if (q == 0) {
      long long s = 0;
      for (int w = 0; w < WARPS; ++w)
        s += reinterpret_cast<const uint32_t*>(smem + wb * w +
                                               (size_t)nacc * G * 8)[g];
      part_i[out] = s;
      continue;
    }
    const int l = q - 1;
    const size_t at = (size_t)l * G + g;
    if ((ln.fsum_bits >> l) & 1u) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w)
        s += *reinterpret_cast<const float*>(
            reinterpret_cast<const long long*>(smem + wb * w) + at);
      part_f[((long long)blockIdx.x * nacc + l) * G + g] = s;
    } else if (MM && (((ln.min_bits | ln.max_bits) >> l) & 1u)) {
      const bool lo = (ln.min_bits >> l) & 1u;
      const bool wide = (ln.wide_lane_bits >> l) & 1u;
      long long m = 0;
      for (int w = 0; w < WARPS; ++w) {
        const long long* slot =
            reinterpret_cast<const long long*>(smem + wb * w) + at;
        const long long v =
            wide ? *slot : (long long)*reinterpret_cast<const int*>(slot);
        m = w == 0 ? v : minmax(m, v, lo);
      }
      part_i[out] = m;
    } else {
      long long s = 0;
      for (int w = 0; w < WARPS; ++w)
        s += reinterpret_cast<const long long*>(smem + wb * w)[at];
      part_i[out] = s;
    }
  }
}

// out_i (1 + nl, G): counts, then int sums, mins and maxes (MM); out_f
// (nl, G): float sums.  One warp per (quantity, group).
template <bool MM>
__global__ void __launch_bounds__(THREADS)
group_agg_combine(const long long* __restrict__ part_i,
                  const float* __restrict__ part_f, int nblocks, int nl,
                  int G, unsigned fsum_bits, unsigned min_bits,
                  unsigned max_bits, long long* __restrict__ out_i,
                  float* __restrict__ out_f) {
  const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int rows = 1 + nl;
  if (item >= rows * G) return;                       // warp-uniform
  const int q = item / G;
  const int g = item - q * G;
  const unsigned bit = q > 0 ? 1u << (q - 1) : 0u;
  if (MM && ((min_bits | max_bits) & bit)) {
    const bool lo = min_bits & bit;
    long long m = lo ? LLONG_MAX : LLONG_MIN;         // block 0 always read
    for (int b = lane; b < nblocks; b += 32)
      m = minmax(m, part_i[((long long)b * rows + q) * G + g], lo);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = minmax(m, __shfl_xor_sync(FULL, m, off), lo);
    if (lane == 0) out_i[q * G + g] = m;
  } else if (fsum_bits & bit) {
    float s = 0.f;
    for (int b = lane; b < nblocks; b += 32)
      s += part_f[((long long)b * nl + (q - 1)) * G + g];
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

template <int NA, bool MM, bool WIDE>
cudaError_t launch_partial(const int32_t* gid, const uint8_t* mask,
                           const Lanes& ln, int nl, long long n, int G,
                           int nblocks, long long rows_per_block,
                           long long* part_i, float* part_f,
                           cudaStream_t st) {
  const size_t smem = warp_bytes(MM ? nl : NA, NA, G) * WARPS;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_agg_partial<NA, MM, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  group_agg_partial<NA, MM, WIDE><<<nblocks, THREADS, smem, st>>>(
      gid, mask, ln, nl, n, G, rows_per_block, part_i, part_f);
  return cudaGetLastError();
}

template <bool MM, bool WIDE>
cudaError_t launch_partial_na(int na, const int32_t* gid,
                              const uint8_t* mask, const Lanes& ln, int nl,
                              long long n, int G, int nblocks,
                              long long rows_per_block, long long* part_i,
                              float* part_f, cudaStream_t st) {
  switch (na) {
    case 0:
      if constexpr (!MM) return launch_partial<0, false, false>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
      return cudaErrorInvalidValue;   // a min/max lane reads an argument
    case 1: return launch_partial<1, MM, WIDE>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
    case 2: return launch_partial<2, MM, WIDE>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
    case 3: return launch_partial<3, MM, WIDE>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
    case 4: return launch_partial<4, MM, WIDE>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
    case 5: return launch_partial<5, MM, WIDE>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
    case 6: return launch_partial<6, MM, WIDE>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
    case 7: return launch_partial<7, MM, WIDE>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
    default: return launch_partial<8, MM, WIDE>(gid, mask, ln, nl, n, G, nblocks, rows_per_block, part_i, part_f, st);
  }
}

}  // namespace

// gid (n,) int32, mask (n,) bool bytes, arg_ptrs: host array of `na`
// device pointers to (n,) columns, int64 where bit a of wide_bits is set,
// f32 where bit a of float_bits is, else int32.  Lane l (of nl) reads
// argument lane_arg[l] and takes lane_kind[l]: 0 its sum (int32 or f32
// arguments), 1 its min, 2 its max (integer arguments; init[l] is where the
// lane starts: the storage type's largest value for a min, its smallest for
// a max).  Every argument has a lane, and at most one of each kind; na = nl
// = 0 counts alone.  part_i (nblocks, 1 + nl, G) int64 and part_f
// (nblocks, max(nl, 1), G) f32 are scratch; out_i (1 + nl, G) int64 gets
// the counts, int sums, mins and maxes, out_f (max(nl, 1), G) f32 the float
// sums.
extern "C" int msdb_group_agg(const int32_t* gid, const uint8_t* mask,
                              const void* const* arg_ptrs, int na,
                              unsigned float_bits, unsigned wide_bits,
                              const signed char* lane_arg,
                              const signed char* lane_kind,
                              const long long* init, int nl, long long n,
                              int G, int nblocks, long long rows_per_block,
                              long long* part_i, float* part_f,
                              long long* out_i, float* out_f, void* stream) {
  if (na < 0 || na > MAX_ARGS || nl < na || nl > MAX_LANES || G < 1 ||
      G > MAX_G || nblocks < 1 || rows_per_block < 1 ||
      (long long)nblocks * rows_per_block < n || (float_bits & wide_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes ln = {};
  ln.float_bits = float_bits;
  ln.wide_bits = wide_bits;
  for (int a = 0; a < MAX_ARGS; ++a) {
    ln.p[a] = a < na ? arg_ptrs[a] : nullptr;
    ln.sum[a] = ln.lo[a] = ln.hi[a] = -1;
  }
  for (int l = 0; l < nl; ++l) {
    const int a = lane_arg[l];
    const int kind = lane_kind[l];
    if (a < 0 || a >= na || kind < 0 || kind > 2)
      return static_cast<int>(cudaErrorInvalidValue);
    signed char* slot = kind == 0 ? ln.sum : kind == 1 ? ln.lo : ln.hi;
    const bool is_float = (float_bits >> a) & 1u;
    const bool wide = (wide_bits >> a) & 1u;
    if (slot[a] >= 0 || (kind == 0 && wide) || (kind != 0 && is_float))
      return static_cast<int>(cudaErrorInvalidValue);
    slot[a] = (signed char)l;
    if (kind == 0 && is_float) ln.fsum_bits |= 1u << l;
    if (kind == 1) ln.min_bits |= 1u << l;
    if (kind == 2) ln.max_bits |= 1u << l;
    if (kind != 0 && wide) ln.wide_lane_bits |= 1u << l;
    ln.init[l] = kind == 0 ? 0 : init[l];
  }
  const bool mm = (ln.min_bits | ln.max_bits) != 0u;
  for (int a = 0; a < na; ++a)
    if (mm ? ln.sum[a] < 0 && ln.lo[a] < 0 && ln.hi[a] < 0 : ln.sum[a] != a)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      !mm ? launch_partial_na<false, false>(na, gid, mask, ln, nl, n, G,
                                            nblocks, rows_per_block, part_i,
                                            part_f, st)
      : wide_bits ? launch_partial_na<true, true>(na, gid, mask, ln, nl, n,
                                                  G, nblocks, rows_per_block,
                                                  part_i, part_f, st)
                  : launch_partial_na<true, false>(na, gid, mask, ln, nl, n,
                                                   G, nblocks, rows_per_block,
                                                   part_i, part_f, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = (1 + nl) * G;
  const int grid = (items + WARPS - 1) / WARPS;
  if (mm)
    group_agg_combine<true><<<grid, THREADS, 0, st>>>(
        part_i, part_f, nblocks, nl, G, ln.fsum_bits, ln.min_bits,
        ln.max_bits, out_i, out_f);
  else
    group_agg_combine<false><<<grid, THREADS, 0, st>>>(
        part_i, part_f, nblocks, nl, G, ln.fsum_bits, 0u, 0u, out_i, out_f);
  return static_cast<int>(cudaGetLastError());
}
