// segmin_sq8: per query and per 128-row segment, the minimum of a certified
// lower bound on the true f32 score, from the int8 (SQ8) sidecar.
//
// Replaces: myscaledb_tpu/ops/pallas/distance_q.py::sq8_segmin_lower_bounds
// (Pallas body `_kernel`, pallas_call at :138), and the query quantization
// the JAX package computes in the same jitted function.  With x = s x8 + ex
// per row and q = sq q8 + eq per query, dot_mid = (x8 . q8) * (s * sq) and
//   err = (sqrt(max(sqn, 0)) * |eq| + |ex| * (|q| + |eq|)) * 1.0001 + 1e-6
//   L2      sqn - 2 dot_mid + q_aux - 2 err
//   Cosine  1 - (dot_mid + err) * rnorm(sqn) * q_aux
//   IP      -(dot_mid + err)
// Rows whose mask-and-validity value is 0 (filtered rows and the sidecar's
// padding) give +inf.  Output (nq, n_pad / 128).
//
// Bound on the H100: memory.  Per (padded) row it reads d int8 bytes, three
// f32 side fields and the f32 mask: (d + 16) bytes, ~146 MB at n = 1M
// (1,015,808 padded rows), d = 128, i.e. ~44 us at 3.35 TB/s.  The int8
// products (2 nq d per row) need 0.017 ms at nq = 128 on the int8 tensor
// cores (1,979 TOPS).  The epilogue is the second limit: per (row, query)
// pair L2's bound takes one int-to-float conversion and 10 f32 multiplies,
// adds and subtracts (Cosine 11, IP 8), kept as separate round-to-nearest
// operations, then a select and a min: at nq = 128, 1,015,808 x 128 x 11 =
// 1.43e9 operations, 0.043 ms at the non-FMA f32 rate (33.5e12 a second),
// about the byte bound, and each issue slot they take is one the
// reductions and loads around them cannot.
//
// Queries.  `quantize_queries_kernel` (one block per query) writes q8 and
// the query terms qside = [sq, |eq|, |q| + |eq|, q_aux] into the caller's
// scratch, so no PyTorch operation runs before the scan.  q8 equals the
// plain version's (the max, the division and the round-half-even are
// exact operations); the norms are sums in another order than PyTorch's,
// within a few f32 ulps, which the 1.0001x + 1e-6 slack absorbs.
//
// Two branches, chosen in msdb_segmin_sq8 by whether the queries' q8 fits
// the wgmma branch's shared memory (N d <= 128 KB):
//
// * When it does not (`segmin_sq8_dp4a`: past d = 1024 at 128 queries,
//   past d = 8192 at 16): one 128-thread block per segment, one thread
//   per row.  The block stages 128 rows x 128 bytes of x8 in shared
//   memory with coalesced 16-byte loads (padded stride of 33 words: no
//   bank conflicts when each thread walks its own row) and 8 queries'
//   int8 chunk, read as broadcast int4s; __dp4a sums the products.  Up to
//   8 queries the sidecar is read once; past 8 it is read once per tile
//   of 8.
// * Otherwise, from one query on (`segmin_sq8_wgmma`): the sidecar is read
//   once for all queries, and at 1 to 8 queries too the tensor cores'
//   products leave the issue slots to the loads and the epilogue (the
//   times of both branches are in PERF.md, K1).  A persistent grid, two
//   blocks per SM, walks the segments.  Thread 0 keeps a ring of 4 stages in
//   flight, 2 steps ahead: each step is one (segment, 128-byte chunk of
//   the dims), a TMA tile of 128 rows x 128 bytes with the 128-byte
//   swizzle, and for a segment's first chunk its three side rows and its
//   mask (4 x 512 bytes) by 1-D bulk copies into the same stage.  The
//   queries' q8 (N x d bytes, N = nq rounded up to 16, 32, 64 or 128, rows
//   past nq zero-filled by TMA) and qside are loaded once per block.  Each
//   of the block's two warpgroups owns 64 rows of the segment and runs
//   wgmma.m64nNk32.s32.s8.s8 (A = the x8 tile, B = the queries, both
//   K-major as the data lies, through 128B-swizzle descriptors), four per
//   128-byte chunk.  The int32 sums are exact, as __dp4a's are: |dot| <=
//   127^2 d < 2^24 for d < 1040.
//
// Epilogue, the same in both branches (`make_row`, `lower_bound`): the
// formula above with round-to-nearest intrinsics, so nvcc cannot contract
// it into FMAs, over the same integer sums: the wgmma branch equals the
// __dp4a branch bit for bit, and both agree with the plain PyTorch version
// up to the ordering of the query norms and sqrt rounding.  Cosine uses
// 1.0f/sqrtf.  Against the epilogue's cost: the row terms (|x|, 1/|x|,
// scale, residual) and the query terms are computed once, not per pair;
// L2's two doublings are folded into the row terms (lower_bound); query
// tiles of 8 past nq are skipped; the wgmma branch takes the minimum over
// the 8 row lanes of a fragment column by three halving exchanges (each
// lane sends half its columns: 7N/32 shuffles a thread, not 3N/4), then
// over the block's 8 warps through shared memory.

#include "hopper.cuh"

namespace {

constexpr int SEG = 128;          // rows per segment
constexpr int DKB = 128;          // int8 feature bytes per chunk
constexpr int DKW = DKB / 4;      // ... as 32-bit words
constexpr int QT = 8;             // queries of the __dp4a branch
constexpr int XS = DKW + 1;       // padded shared-memory row stride (words)
constexpr int WARPS = SEG / 32;
constexpr int NQ_MAX = 128;
constexpr int Q_SMEM_MAX = 128 * 1024;  // q8 bytes the wgmma branch holds
constexpr float INV_127 = 0x1.020408p-7f;  // f32(1/127), as the sidecar's

// the row terms of the bound; for L2 each doubled (see lower_bound)
struct Row {
  float sqn, resid, scale, xnorm, rnorm;
  bool keep;
};

// the query terms: sq (query scale), |eq|, |q| + |eq|, q_aux
struct Query {
  float sq, qe, qne, qaux;
};

__device__ __forceinline__ Row make_row(float sqn, float resid, float scale,
                                        float mask, int metric) {
  Row r;
  r.sqn = sqn;
  r.keep = mask != 0.f;
  const float xnorm = sqrtf(fmaxf(sqn, 0.f));
  r.rnorm = (metric == 1 && sqn > 0.f) ? 1.0f / sqrtf(fmaxf(sqn, 1e-30f))
                                       : 0.f;
  const float k = metric == 0 ? 2.f : 1.f;
  r.resid = __fmul_rn(k, resid);
  r.scale = __fmul_rn(k, scale);
  r.xnorm = __fmul_rn(k, xnorm);
  return r;
}

// L2 needs 2 dot_mid and 2 err, which are (dot * (2 s * sq)) and
// ((2 |x| * |eq| + 2 |ex| * (|q| + |eq|)) * 1.0001 + 2e-6): doubling is
// exact and commutes with round-to-nearest, so the doubled row terms give
// the same values with two operations fewer a pair (not where a product
// falls below f32's normal range, 1.2e-38, whose spacing is absolute)
__device__ __forceinline__ float lower_bound(int dot, const Row& r,
                                             const Query& q, int metric) {
  const float dot_mid =
      __fmul_rn(static_cast<float>(dot), __fmul_rn(r.scale, q.sq));
  float err = __fadd_rn(__fmul_rn(r.xnorm, q.qe), __fmul_rn(r.resid, q.qne));
  err = __fadd_rn(__fmul_rn(err, 1.0001f),
                  metric == 0 ? 2.f * 1e-6f : 1e-6f);
  float lb;
  if (metric == 0)
    lb = __fsub_rn(__fadd_rn(__fsub_rn(r.sqn, dot_mid), q.qaux), err);
  else if (metric == 1)
    lb = __fsub_rn(1.f,
                   __fmul_rn(__fmul_rn(__fadd_rn(dot_mid, err), r.rnorm),
                             q.qaux));
  else
    lb = -__fadd_rn(dot_mid, err);
  return r.keep ? lb : __int_as_float(0x7f800000);  // +inf
}

// ---------------------------------------------------------------- queries

constexpr int QP_THREADS = 128;

// sum (or max) over the block, in a fixed order
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : __fadd_rn(v, o);
  }
  __syncthreads();  // part is free
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int w = 1; w < QP_THREADS / 32; ++w)
    v = MAX ? fmaxf(v, part[w]) : __fadd_rn(v, part[w]);
  return v;
}

// per query: sq = max(max|q| * f32(1/127), 1e-30), q8 = clamp(rint(q / sq),
// -127, 127), and qside (the plain version's quantize_queries)
__global__ void __launch_bounds__(QP_THREADS)
quantize_queries_kernel(const float* __restrict__ q, int8_t* __restrict__ q8,
                        float* __restrict__ qside, int d, int metric) {
  __shared__ float part[QP_THREADS / 32];
  const float* qr = q + (long long)blockIdx.x * d;
  int8_t* q8r = q8 + (long long)blockIdx.x * d;
  float m = 0.f;
  for (int i = threadIdx.x; i < d; i += QP_THREADS) m = fmaxf(m, fabsf(qr[i]));
  const float sq = fmaxf(__fmul_rn(block_reduce<true>(m, part), INV_127),
                         1e-30f);
  float se = 0.f, sn = 0.f;
  for (int i = threadIdx.x; i < d; i += QP_THREADS) {
    const float v = qr[i];
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v, sq)), -127.f), 127.f);
    q8r[i] = static_cast<int8_t>(static_cast<int>(r));
    const float e = __fsub_rn(v, __fmul_rn(r, sq));
    se = __fadd_rn(se, __fmul_rn(e, e));
    sn = __fadd_rn(sn, __fmul_rn(v, v));
  }
  se = block_reduce<false>(se, part);
  sn = block_reduce<false>(sn, part);
  if (threadIdx.x == 0) {
    const float qe = sqrtf(se), qn = sqrtf(sn);
    float qaux = 0.f;
    if (metric == 0) qaux = sn;
    else if (metric == 1 && qn > 0.f) qaux = __fdiv_rn(1.f, qn);
    float* o = qside + 4LL * blockIdx.x;
    o[0] = sq;
    o[1] = qe;
    o[2] = __fadd_rn(qn, qe);
    o[3] = qaux;
  }
}

// ------------------------------- queries past the shared memory (__dp4a)

__global__ void __launch_bounds__(SEG)
segmin_sq8_dp4a(const int8_t* __restrict__ x8, const float* __restrict__ sides,
                const int8_t* __restrict__ q8,
                const float* __restrict__ qside,
                const float* __restrict__ mv, float* __restrict__ out,
                int n_pad, int d, int nq, int nseg, int metric) {
  __shared__ int xs[SEG * XS];
  __shared__ __align__(16) int qs[DKW * QT];
  __shared__ float red[WARPS][QT];

  const int t = threadIdx.x;
  const int seg = blockIdx.x;
  const long long row0 = (long long)seg * SEG;
  const long long row = row0 + t;
  const Row rw = make_row(sides[row], sides[(long long)n_pad + row],
                          sides[2LL * n_pad + row], mv[row], metric);

  for (int q0 = 0; q0 < nq; q0 += QT) {
    int acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0;

    for (int k0 = 0; k0 < d; k0 += DKB) {
      __syncthreads();  // readers of the previous chunk are done
      // x8 chunk: SEG rows x 128 bytes, 8 int4 per thread; 8 consecutive
      // threads read one row's 128 contiguous bytes
#pragma unroll
      for (int p = 0; p < (SEG * DKB / 16) / SEG; ++p) {
        const int f = t + p * SEG;
        const int r = f / (DKB / 16);
        const int c4 = f % (DKB / 16);
        const int4 v = *reinterpret_cast<const int4*>(
            x8 + (row0 + r) * d + k0 + c4 * 16);
        int* dst = xs + r * XS + c4 * 4;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      // query chunk as packed words, word-major: qs[w * QT + j]
      for (int e = t; e < QT * DKW; e += SEG) {
        const int j = e / DKW;
        const int w = e % DKW;
        qs[w * QT + j] =
            (q0 + j < nq)
                ? *reinterpret_cast<const int*>(
                      q8 + (long long)(q0 + j) * d + k0 + w * 4)
                : 0;
      }
      __syncthreads();
      const int* xr = xs + t * XS;
#pragma unroll 8
      for (int w = 0; w < DKW; ++w) {
        const int xv = xr[w];
        const int4 qa = *reinterpret_cast<const int4*>(qs + w * QT);
        const int4 qb = *reinterpret_cast<const int4*>(qs + w * QT + 4);
        acc[0] = __dp4a(xv, qa.x, acc[0]);
        acc[1] = __dp4a(xv, qa.y, acc[1]);
        acc[2] = __dp4a(xv, qa.z, acc[2]);
        acc[3] = __dp4a(xv, qa.w, acc[3]);
        acc[4] = __dp4a(xv, qb.x, acc[4]);
        acc[5] = __dp4a(xv, qb.y, acc[5]);
        acc[6] = __dp4a(xv, qb.z, acc[6]);
        acc[7] = __dp4a(xv, qb.w, acc[7]);
      }
    }

#pragma unroll
    for (int j = 0; j < QT; ++j) {
      Query qq{0.f, 0.f, 0.f, 0.f};
      if (q0 + j < nq) {
        const float* qsd = qside + 4LL * (q0 + j);
        qq = Query{qsd[0], qsd[1], qsd[2], qsd[3]};
      }
      float lb = lower_bound(acc[j], rw, qq, metric);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lb = fminf(lb, __shfl_xor_sync(0xffffffffu, lb, off));
      if ((t & 31) == 0) red[t >> 5][j] = lb;
    }
    __syncthreads();
    if (t < QT && q0 + t < nq) {
      float m = red[0][t];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) m = fminf(m, red[w][t]);
      out[(long long)(q0 + t) * nseg + seg] = m;
    }
  }
}

// ------------------------------------ queries in shared memory (wgmma)

constexpr int STAGES = 4;
constexpr uint32_t X_BYTES = SEG * DKB;          // one chunk of a segment
constexpr uint32_t SIDE_BYTES = 4 * SEG * 4;     // sqn, resid, scale, mask
constexpr uint32_t STAGE_BYTES = X_BYTES + SIDE_BYTES;
constexpr int THREADS = 256;                     // two warpgroups
constexpr int ROW_WARPS = THREADS / 32;          // 16 rows each

// D (64 x N, int32, in registers) += A (64 x 32 int8) B (N x 32 int8)^T,
// both from shared memory through descriptors
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

struct Maps {
  CUtensorMap x, q;   // x8 and q8, both read as 128-byte-wide swizzled tiles
};

// the copies of ring step i (segment, 128-byte chunk) into stage i % STAGES:
// the x8 tile, and with a segment's first chunk its side rows and mask
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, const Maps& maps,
                                        const float* sides, const float* mv,
                                        int n_pad, int i, int kc) {
  const int s = i % STAGES;
  // stage s is free once every warp has released step i - STAGES
  mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
  const int seg = blockIdx.x + (i / kc) * gridDim.x;
  const int k = i % kc;
  unsigned char* dst = ring + s * STAGE_BYTES;
  if (k == 0) {
    mbar_expect_tx(&full[s], X_BYTES + SIDE_BYTES);
    tma_load(dst, &maps.x, 0, seg * SEG, &full[s]);
    const long long r0 = (long long)seg * SEG;
    for (int f = 0; f < 3; ++f)
      bulk_load(dst + X_BYTES + f * SEG * 4, sides + f * (long long)n_pad + r0,
                SEG * 4, &full[s]);
    bulk_load(dst + X_BYTES + 3 * SEG * 4, mv + r0, SEG * 4, &full[s]);
  } else {
    mbar_expect_tx(&full[s], X_BYTES);
    tma_load(dst, &maps.x, k * DKB, seg * SEG, &full[s]);
  }
}

// one halving exchange across the lanes `m` apart: of the CNT values in
// v[0, CNT), a lane whose bit m is clear keeps the lower half and the
// other the upper half, each taking the min with its partner's copy
template <int CNT, int V>
__device__ __forceinline__ void exchange(float (&v)[V], int m) {
  const bool up = (threadIdx.x & m) != 0;
#pragma unroll
  for (int i = 0; i < CNT / 2; ++i) {
    const float send = up ? v[i] : v[i + CNT / 2];
    const float keep = up ? v[i + CNT / 2] : v[i];
    v[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, m));
  }
}

// N: queries rounded up to a wgmma width (16, 32, 64, 128)
template <int N, int METRIC>
__global__ void __launch_bounds__(THREADS, 2)
segmin_sq8_wgmma(const __grid_constant__ Maps maps,
                 const float* __restrict__ sides,
                 const float* __restrict__ qside,
                 const float* __restrict__ mv, float* __restrict__ out,
                 int n_pad, int kc, int nq, int nseg) {
  constexpr int R = N / 2;   // accumulators a thread: rows r0, r0 + 8
  constexpr int V = N / 4;   // columns a thread: 8 j + 2 t + c
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  __shared__ __align__(8) uint64_t qbar;

  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qt = ring + STAGES * STAGE_BYTES;  // kc tiles of N x 128 B
  float4* qs = reinterpret_cast<float4*>(qt + kc * N * DKB);  // N x Query
  float* red = reinterpret_cast<float*>(qs + N);    // [2][ROW_WARPS][N]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool producer = threadIdx.x == 0;
  // ring steps of this block: its segments times the chunks of each
  const int steps = ((nseg - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * kc;

  for (int c = nq + threadIdx.x; c < N; c += THREADS)
    qs[c] = make_float4(0.f, 0.f, 0.f, 0.f);   // columns past nq
  if (producer) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ROW_WARPS);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    mbar_expect_tx(&qbar, kc * N * DKB + nq * 16);
    for (int k = 0; k < kc; ++k)
      tma_load(qt + k * N * DKB, &maps.q, k * DKB, 0, &qbar);
    bulk_load(qs, qside, nq * 16, &qbar);
    for (int i = 0; i < STAGES - 2 && i < steps; ++i)
      produce(ring, full, empty, maps, sides, mv, n_pad, i, kc);
  }
  mbar_wait(&qbar, 0);

  // warp w holds rows 16 w + g and 16 w + g + 8 of the segment: rows
  // 16 (w % 4) + g (+ 8) of warpgroup w / 4's 64-row tile
  const int r0 = warp * 16 + g;
  const float inf = __int_as_float(0x7f800000);
  int acc[R];
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0;
  int it = 0, buf = 0;
  for (int seg = blockIdx.x; seg < nseg; seg += gridDim.x, buf ^= 1) {
    Row rw[2];
    for (int k = 0; k < kc; ++k, ++it) {
      if (producer && it + STAGES - 2 < steps)
        produce(ring, full, empty, maps, sides, mv, n_pad, it + STAGES - 2,
                kc);
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      __syncwarp();  // wgmma wants the warp converged
      const unsigned char* xs = ring + s * STAGE_BYTES;
      if (k == 0) {
        const float* sd = reinterpret_cast<const float*>(xs + X_BYTES);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          rw[h] = make_row(sd[r], sd[SEG + r], sd[2 * SEG + r],
                           sd[3 * SEG + r], METRIC);
        }
      }
      const uint64_t da = smem_desc(xs + (warp >> 2) * 64 * DKB);
      const uint64_t db = smem_desc(qt + k * N * DKB);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DKB / 32; ++ks)
        Wgmma<N>::mma(acc, da + 2 * ks, db + 2 * ks, k > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // acc[4 j + 2 h + c] is row r0 + 8 h, query 8 j + 2 t + c
    float v[V];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (8 * j < nq) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 qv = qs[8 * j + 2 * t + c];
          const Query qq{qv.x, qv.y, qv.z, qv.w};
          v[2 * j + c] =
              fminf(lower_bound(acc[4 * j + c], rw[0], qq, METRIC),
                    lower_bound(acc[4 * j + 2 + c], rw[1], qq, METRIC));
        }
      } else {
        v[2 * j] = inf;
        v[2 * j + 1] = inf;
      }
    }
    // min over the 8 lanes g that hold the same columns: after the
    // exchanges over g's bits 0, 1 (and 2), lane g holds F = max(V / 8, 1)
    // of its columns, v[f] = column index i = b0 V/2 + b1 V/4 (+ b2 V/8) + f
    exchange<V, V>(v, 4);
    exchange<V / 2, V>(v, 8);
    if constexpr (V >= 8) {
      exchange<V / 4, V>(v, 16);
    } else {
      v[0] = fminf(v[0], __shfl_xor_sync(0xffffffffu, v[0], 16));
    }
    constexpr int F = V >= 8 ? V / 8 : 1;
    const int base = ((g & 1) ? V / 2 : 0) + ((g & 2) ? V / 4 : 0) +
                     ((V >= 8 && (g & 4)) ? V / 8 : 0);
    if (V >= 8 || (g & 4) == 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int i = base + f;
        red[(buf * ROW_WARPS + warp) * N + 8 * (i >> 1) + 2 * t + (i & 1)] =
            v[f];
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

int wgmma_smem(int N, int kc) {
  return 1024 + STAGES * STAGE_BYTES + kc * N * DKB + N * 16 +
         2 * ROW_WARPS * N * (int)sizeof(float);
}

template <int N, int METRIC>
cudaError_t launch_wgmma_kernel(const int8_t* x8, const float* sides,
                                const int8_t* q8, const float* qside,
                                const float* mv, float* out, int n_pad, int d,
                                int nq, cudaStream_t stream) {
  const int nseg = n_pad / SEG;
  const int kc = d / DKB;
  const int smem = wgmma_smem(N, kc);
  Maps maps;
  if (!tma_map_2d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x8, n_pad, d,
                  DKB, SEG) ||
      !tma_map_2d(&maps.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q8, nq, d, DKB,
                  N))
    return cudaErrorInvalidValue;
  auto kernel = segmin_sq8_wgmma<N, METRIC>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                     smem);
  if (rc != cudaSuccess) return cudaGetLastError();
  const long long room = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = static_cast<int>(nseg < room ? nseg : room);
  kernel<<<blocks, THREADS, smem, stream>>>(maps, sides, qside, mv, out,
                                            n_pad, kc, nq, nseg);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_wgmma(const int8_t* x8, const float* sides,
                         const int8_t* q8, const float* qside,
                         const float* mv, float* out, int n_pad, int d, int nq,
                         int metric, cudaStream_t stream) {
  if (metric == 0)
    return launch_wgmma_kernel<N, 0>(x8, sides, q8, qside, mv, out, n_pad, d,
                                     nq, stream);
  if (metric == 1)
    return launch_wgmma_kernel<N, 1>(x8, sides, q8, qside, mv, out, n_pad, d,
                                     nq, stream);
  return launch_wgmma_kernel<N, 2>(x8, sides, q8, qside, mv, out, n_pad, d,
                                   nq, stream);
}

int wgmma_width(int nq) {
  return nq <= 16 ? 16 : nq <= 32 ? 32 : nq <= 64 ? 64 : 128;
}

}  // namespace

// The branch msdb_segmin_sq8 takes for nq queries of d dims: 1 for the
// wgmma kernel, 0 for the __dp4a kernel (the queries' q8 does not fit the
// wgmma kernel's shared memory).
extern "C" int msdb_segmin_sq8_branch(int nq, int d) {
  return wgmma_width(nq) * d <= Q_SMEM_MAX ? 1 : 0;
}

// q: (nq, d) f32 queries; scratch: nq d bytes for q8, then nq x 4 f32 for
// qside (the wrapper allocates it); out: (nq, n_pad / 128) f32
extern "C" int msdb_segmin_sq8(const int8_t* x8, const float* sides,
                               const float* q, void* scratch, const float* mv,
                               float* out, int n_pad, int d, int nq,
                               int metric, void* stream) {
  const int nseg = n_pad / SEG;
  if (nseg <= 0 || nq <= 0) return static_cast<int>(cudaGetLastError());
  if (nq > NQ_MAX || d % DKB != 0 || n_pad % SEG != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q8 = static_cast<int8_t*>(scratch);
  float* qside = reinterpret_cast<float*>(q8 + (size_t)nq * d);
  quantize_queries_kernel<<<nq, QP_THREADS, 0, s>>>(q, q8, qside, d, metric);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!msdb_segmin_sq8_branch(nq, d)) {
    segmin_sq8_dp4a<<<nseg, SEG, 0, s>>>(x8, sides, q8, qside, mv, out,
                                         n_pad, d, nq, nseg, metric);
    return static_cast<int>(cudaGetLastError());
  }
  switch (wgmma_width(nq)) {
    case 16:
      rc = launch_wgmma<16>(x8, sides, q8, qside, mv, out, n_pad, d, nq,
                            metric, s);
      break;
    case 32:
      rc = launch_wgmma<32>(x8, sides, q8, qside, mv, out, n_pad, d, nq,
                            metric, s);
      break;
    case 64:
      rc = launch_wgmma<64>(x8, sides, q8, qside, mv, out, n_pad, d, nq,
                            metric, s);
      break;
    default:
      rc = launch_wgmma<128>(x8, sides, q8, qside, mv, out, n_pad, d, nq,
                             metric, s);
  }
  return static_cast<int>(rc);
}
