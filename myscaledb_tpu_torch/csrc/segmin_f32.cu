// segmin_f32: per query and per 128-row segment, the minimum of the f32
// selection score of the exact two-stage vector scan.
//
// Replaces: myscaledb_tpu/ops/pallas/distance.py::fused_segmin_scores
// (Pallas body `_kernel`).  Scores, for dot = x_row . q:
//   L2      sqn - 2 dot + q_aux            (q_aux = |q|^2)
//   Cosine  1 - dot * rnorm(sqn) * q_aux   (q_aux = 1/|q|, rnorm = 1/sqrt)
//   IP      -dot
// Rows with mask == 0 and rows >= n score +inf.  Output (nq, ceil(n/128)).
//
// Bound on the H100: each x row is read once, plus sqn and the f32 mask:
// (4 d + 8) bytes per row, 520 MB at n = 1M, d = 128, 0.155 ms at 3.35
// TB/s.  The products run on the tensor cores in TF32 with three products
// per term (below), 3 x 2 nq n d operations at 495 TFLOP/s: 0.20 ms at nq =
// 128, so the kernel is bound by bytes up to nq ~ 100 and by operations
// beyond.
//
// Products: 3xTF32 on the tensor cores.  Each f32 value a splits into
// a_hi = tf32(a) and a_lo = tf32(a - a_hi) (cvt.rna: round to nearest,
// ties away), and
//   dot = sum  a_lo b_hi + a_hi b_lo + a_hi b_hi
// in f32, the small terms first.  The dropped a_lo b_lo and the roundings
// leave about 2^-21 of each term.  The tensor cores sum their products with
// truncation, which over a long run of products into one accumulator
// drifts beyond the tolerance for rows of large norm, so each 32-dim chunk
// sums into fresh registers, added to the running sums with
// round-to-nearest adds.  The queries are split once per call by
// `split_queries` into a scratch block that the wrapper allocates; x is
// split in registers.  From 17 queries on, the products are
// wgmma.m64nNk8 (N = 8 NT, all queries of the call): A = a warpgroup's 64
// rows of x from registers, B = the queries read by wgmma from shared
// memory through a descriptor of the 128B-swizzled layout that TMA
// writes.  Up to 16 queries, where the scan is bound by bytes, they are
// mma.sync.m16n8k8, which costs a warp less time per chunk
// (chunk_mma_sync and chunk_wgmma below).
//
// Feeding: a persistent grid, a few blocks per SM, each walking over
// 128-row segments.  Thread 0 streams each (segment, 32-dim chunk) as
// three TMA tiles (128 rows x 32 f32 of x, 16 KB, and the hi and lo halves
// of the queries' 32 dims) into a ring of `stages` stages with full/empty
// mbarriers, stages - 2 steps ahead, so the next tiles are in flight while
// the current one computes.  TMA swizzles each 128-byte row (16-byte chunk c
// of row r lands at c ^ (r & 7)), which makes the A loads free of bank
// conflicts, and fills rows >= n (and queries >= nq) with zeros; x is
// never padded.  A block is two warpgroups, 8 warps of 16 rows each.
//
// Epilogue, unchanged in meaning: the round-to-nearest formulas above (no
// FMA contraction; Cosine's 1/sqrtf correctly rounded), +inf for masked
// rows and rows past n, the minimum over the 16 rows of a warp by shuffles
// and over the segment's 8 warps through shared memory.

#include "hopper.cuh"

namespace {

constexpr int SEG = 128;                 // rows per segment
constexpr int DK = 32;                   // dims per stage: 128 bytes a row
constexpr int ROW_WARPS = SEG / 16;      // one m16 tile each
constexpr int NQ_MAX = 128;
constexpr uint32_t X_BYTES = SEG * DK * 4;

// byte offset of 16-byte chunk c of row r in a 128B-swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// D (64 x N, f32, in registers) += A (64 x 8 TF32, in registers) x B (N x 8
// TF32 from shared memory, K-major), for the N that chunk_wgmma takes
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
        "%67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float comp(const float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

struct Maps {
  CUtensorMap x, qhi, qlo;   // x, and the two halves of the split queries
};

// the TMA loads of ring step i, (segment, 32-dim chunk), into stage
// i % stages: the x tile, then the query block's hi and lo tiles
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int stages,
                                        uint32_t q_bytes, const Maps& maps,
                                        int i, int kc) {
  const int s = i % stages;
  // stage s is free once every warp has released step i - stages
  mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
  mbar_expect_tx(&full[s], X_BYTES + 2 * q_bytes);
  unsigned char* dst = ring + s * (X_BYTES + 2 * q_bytes);
  const int seg = blockIdx.x + (i / kc) * gridDim.x;
  const int k0 = (i % kc) * DK;
  tma_load(dst, &maps.x, k0, seg * SEG, &full[s]);
  tma_load(dst + X_BYTES, &maps.qhi, k0, 0, &full[s]);
  tma_load(dst + X_BYTES + q_bytes, &maps.qlo, k0, 0, &full[s]);
}

// the queries' 3xTF32 halves, once per call: qs[0] = tf32(q), qs[1] =
// tf32(q - qs[0]), as TF32 bit patterns
__global__ void split_queries(const float* __restrict__ q,
                              uint32_t* __restrict__ qs, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) split(q[i], qs[i], qs[count + i]);
}

// One 32-dim chunk into the running sums acc (the C/D fragment layout of
// both MMAs: acc[4 j + 2 h + c] is row r0 + 8 h, query 8 j + 2 t + c).
// Each chunk sums into fresh registers, added to acc with round-to-nearest
// adds: the tensor cores' own accumulation rounds toward zero, which over
// 3 d / 8 products in a row drifts by more than the tolerance when a row's
// norm is large.
//
// Up to 16 queries the scan is bound by bytes, and mma.sync.m16n8k8, which
// a warp issues and finishes on its own, is quicker than a warpgroup's
// wgmma with its fence and wait.  Lane (g, t) reads dims 8t..8t+7 of its
// rows and queries with 16-byte loads; k-step s pairs MMA positions t and
// t + 4 with dims 8t + s and 8t + 4 + s, the same permutation on both
// sides, so every dim enters the sum once.
template <int NT>
__device__ __forceinline__ void chunk_mma_sync(float (&acc)[NT * 4],
                                               const unsigned char* xs,
                                               const unsigned char* qh,
                                               const unsigned char* ql,
                                               int r0, int g, int t) {
  float4 a[2][2];  // [row r0 + 8 h][16-byte chunk 2 t + c]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      a[h][c] = *reinterpret_cast<const float4*>(xs + swz(r0 + 8 * h,
                                                          2 * t + c));
  uint32_t ahi[4][4], alo[4][4];  // [k-step][fragment register]
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    split(comp(a[0][0], st), ahi[st][0], alo[st][0]);  // (g, t)
    split(comp(a[1][0], st), ahi[st][1], alo[st][1]);  // (g + 8, t)
    split(comp(a[0][1], st), ahi[st][2], alo[st][2]);  // (g, t + 4)
    split(comp(a[1][1], st), ahi[st][3], alo[st][3]);  // (g + 8, t + 4)
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float small[4] = {0.f, 0.f, 0.f, 0.f};   // two independent chains
    float large[4] = {0.f, 0.f, 0.f, 0.f};
    const int qr = j * 8 + g;
    const uint4 h0 = *reinterpret_cast<const uint4*>(qh + swz(qr, 2 * t));
    const uint4 h1 = *reinterpret_cast<const uint4*>(qh + swz(qr, 2 * t + 1));
    const uint4 l0 = *reinterpret_cast<const uint4*>(ql + swz(qr, 2 * t));
    const uint4 l1 = *reinterpret_cast<const uint4*>(ql + swz(qr, 2 * t + 1));
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      mma(small, alo[st], word(h0, st), word(h1, st));
      mma(small, ahi[st], word(l0, st), word(l1, st));
      mma(large, ahi[st], word(h0, st), word(h1, st));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * j + e] =
          __fadd_rn(acc[4 * j + e], __fadd_rn(small[e], large[e]));
  }
}

// From 17 queries on, one wgmma.m64nNk8 per product takes all queries of
// the call for the warpgroup's 64 rows, B straight from shared memory.
// wgmma reads B's k8 steps in order, so lane (g, t) takes dims 8 s + t and
// 8 s + t + 4 of its rows at k-step s (conflict-free 4-byte loads).
template <int NT>
__device__ __forceinline__ void chunk_wgmma(float (&acc)[NT * 4],
                                            const unsigned char* xs,
                                            const unsigned char* qh,
                                            const unsigned char* ql, int r0,
                                            int t) {
  constexpr int N = NT * 8;
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int st = 0; st < 4; ++st)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float v = *reinterpret_cast<const float*>(
          xs + swz(r0 + 8 * (f & 1), 2 * st + (f >> 1)) + 4 * t);
      split(v, ahi[st][f], alo[st][f]);
    }
  float part[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) part[e] = 0.f;
  const uint64_t dh = smem_desc(qh), dl = smem_desc(ql);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    Wgmma<N>::mma(part, alo[st], dh + 2 * st, 1);   // small terms first
    Wgmma<N>::mma(part, ahi[st], dl + 2 * st, 1);
    Wgmma<N>::mma(part, ahi[st], dh + 2 * st, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
}

// Ring stages, for every query count: three leave room for a third block
// per SM at one query tile, the shape of the scan's path.
constexpr int STAGES = 3;

// NT: query tiles of 8, N = 8 NT queries per launch (blocks per SM asked
// of the register allocator: three at one tile, where the scan is bound by
// bytes)
template <int NT>
__global__ void __launch_bounds__(32 * ROW_WARPS, NT == 1 ? 3 : 1)
segmin_f32_kernel(const __grid_constant__ Maps maps,
                  const float* __restrict__ sqn,
                  const float* __restrict__ qaux,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int n, int kc, int nq, int nseg, int metric) {
  constexpr int N = NT * 8;
  constexpr int stages = STAGES;
  constexpr int R = N / 2;                 // accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[stages];
  __shared__ __align__(8) uint64_t empty[stages];

  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_bytes = N * 128;        // one half's tile
  const uint32_t stage_bytes = X_BYTES + 2 * q_bytes;
  // per-warp segment minima, [2 buffers][ROW_WARPS][N]
  float* red = reinterpret_cast<float*>(ring + stages * stage_bytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x == 0;
  // ring steps of this block: its segments times the chunks of each
  const int steps = ((nseg - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * kc;

  if (producer) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], blockDim.x / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the ring runs stages - 2 steps ahead: step it + stages - 2 reuses the
  // stage of step it - 2, which every warp has released by the time
  // thread 0 reaches step it, so its wait rarely blocks warp 0
  if (producer)
    for (int i = 0; i < stages - 2 && i < steps; ++i)
      produce(ring, full, empty, stages, q_bytes, maps, i, kc);

  // warp w holds rows 16 w .. 16 w + 15 of the segment: rows 16 (w % 4) of
  // warpgroup w / 4's 64-row wgmma tile
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;             // and r0 + 8
  const float inf = __int_as_float(0x7f800000);
  int it = 0, buf = 0;
  for (int seg = blockIdx.x; seg < nseg; seg += gridDim.x, buf ^= 1) {
    // the rows' terms, loaded before the chunks arrive
    float sq[2];
    bool keep[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)seg * SEG + r0 + 8 * h;
      keep[h] = row < n;
      sq[h] = keep[h] ? sqn[row] : 0.f;
      if (keep[h] && mask != nullptr) keep[h] = mask[row] != 0.f;
    }

    float acc[R];
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.f;

    for (int k = 0; k < kc; ++k, ++it) {
      if (producer && it + stages - 2 < steps)
        produce(ring, full, empty, stages, q_bytes, maps, it + stages - 2,
                kc);
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      __syncwarp();  // the MMAs want the warp converged
      const unsigned char* xs = ring + s * stage_bytes;
      const unsigned char* qh = xs + X_BYTES;       // TF32 bits
      const unsigned char* ql = qh + q_bytes;
      if constexpr (NT <= 2)
        chunk_mma_sync<NT>(acc, xs, qh, ql, r0, g, t);
      else
        chunk_wgmma<NT>(acc, xs, qh, ql, r0, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: acc[4j + 2h + c] is row r0 + 8h, query 8j + 2t + c
    float rn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rn[h] = (metric == 1 && sq[h] > 0.f)
                  ? 1.0f / sqrtf(fmaxf(sq[h], 1e-30f))
                  : 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j * 8 + 2 * t + c;
        const float qa = col < nq ? qaux[col] : 0.f;
        float m = inf;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dot = acc[4 * j + 2 * h + c];
          float sc;
          if (metric == 0)
            sc = __fadd_rn(__fsub_rn(sq[h], __fmul_rn(2.f, dot)), qa);
          else if (metric == 1)
            sc = __fsub_rn(1.f, __fmul_rn(__fmul_rn(dot, rn[h]), qa));
          else
            sc = -dot;
          m = fminf(m, keep[h] ? sc : inf);
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (g == 0) red[(buf * ROW_WARPS + warp) * N + col] = m;
      }
    }
    __syncthreads();
    const int col = threadIdx.x;
    if (col < nq) {
      const float* r = red + buf * ROW_WARPS * N + col;
      float m = r[0];
#pragma unroll
      for (int w = 1; w < ROW_WARPS; ++w) m = fminf(m, r[w * N]);
      out[(long long)col * nseg + seg] = m;
    }
    // red is double-buffered: the next segment writes the other half, and
    // the one after only once every reader has reached the next
    // __syncthreads
  }
}

// a row-major (rows, cols) f32 matrix read in (box_rows, 32) tiles
bool make_map(CUtensorMap* m, const void* base, int rows, int cols,
              int box_rows) {
  return tma_map_2d(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows, cols,
                    DK, box_rows);
}

template <int NT>
cudaError_t launch(const float* x, const uint32_t* qs, const float* sqn,
                   const float* qaux, const float* mask, float* out, int n,
                   int d, int nq, int metric, cudaStream_t stream) {
  const int nseg = (n + SEG - 1) / SEG;
  const int threads = 32 * ROW_WARPS;
  const int q_bytes = NT * 8 * 128;
  const int smem = STAGES * (X_BYTES + 2 * q_bytes) + 1024 +
                   2 * ROW_WARPS * NT * 8 * (int)sizeof(float);
  Maps maps;
  if (!make_map(&maps.x, x, n, d, SEG) ||
      !make_map(&maps.qhi, qs, nq, d, NT * 8) ||
      !make_map(&maps.qlo, qs + (size_t)nq * d, nq, d, NT * 8))
    return cudaErrorInvalidValue;
  auto kernel = segmin_f32_kernel<NT>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                     smem);
  if (rc != cudaSuccess) return cudaGetLastError();
  const long long room = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = static_cast<int>(nseg < room ? nseg : room);
  kernel<<<blocks, threads, smem, stream>>>(maps, sqn, qaux, mask, out, n,
                                            d / DK, nq, nseg, metric);
  return cudaGetLastError();
}

}  // namespace

// qs: scratch for the split queries, 2 nq d 32-bit words
extern "C" int msdb_segmin_f32(const float* x, const float* q,
                               const float* sqn, const float* qaux,
                               const float* mask, float* qs, float* out,
                               int n, int d, int nq, int metric,
                               void* stream) {
  if (n <= 0 || nq <= 0) return static_cast<int>(cudaGetLastError());
  if (nq > NQ_MAX || d % DK != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* qw = reinterpret_cast<uint32_t*>(qs);
  const int count = nq * d;
  split_queries<<<(count + 255) / 256, 256, 0, s>>>(q, qw, count);
  const int tiles = (nq + 7) / 8;
  cudaError_t rc;
  if (tiles <= 1)
    rc = launch<1>(x, qw, sqn, qaux, mask, out, n, d, nq, metric, s);
  else if (tiles <= 2)
    rc = launch<2>(x, qw, sqn, qaux, mask, out, n, d, nq, metric, s);
  else if (tiles <= 4)
    rc = launch<4>(x, qw, sqn, qaux, mask, out, n, d, nq, metric, s);
  else if (tiles <= 8)
    rc = launch<8>(x, qw, sqn, qaux, mask, out, n, d, nq, metric, s);
  else
    rc = launch<16>(x, qw, sqn, qaux, mask, out, n, d, nq, metric, s);
  return static_cast<int>(rc);
}
