// segmin_sq8: per query and per 128-row segment, the minimum of a certified
// lower bound on the true f32 score, from the int8 (SQ8) sidecar.
//
// Replaces: myscaledb_tpu/ops/pallas/distance_q.py::sq8_segmin_lower_bounds
// (Pallas body `_kernel`).  With x = s x8 + ex per row and q = sq q8 + eq
// per query, dot_mid = (x8 . q8) * (s * sq) and
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
// operations (2 nq d per row) stay far below the int8 rate.
//
// Design (simple first): one 128-thread block per segment, one thread per
// row.  The block stages 128 rows x 128 bytes of x8 in shared memory with
// coalesced 16-byte loads (padded stride of 33 words: no bank conflicts
// when each thread walks its own row) and 8 queries' int8 chunk, read as
// broadcast int4s.  The int8 x int8 products accumulate exactly in int32
// with __dp4a (|dot| <= 127^2 d < 2^24 for d < 1040, so the conversion to
// f32 is exact too).  The bound formula is evaluated with round-to-nearest
// intrinsics in the reference's order, so nvcc cannot contract it into FMAs
// (the 1.0001x + 1e-6 slack would absorb that, but the kernel then also
// agrees with the plain PyTorch version up to sqrt rounding).  Cosine uses
// 1.0f/sqrtf.  The query-side quantization stays in PyTorch in the wrapper,
// as the JAX package keeps it outside pallas_call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 128;          // rows per segment == threads per block
constexpr int DKB = 128;          // int8 feature bytes staged per chunk
constexpr int DKW = DKB / 4;      // ... as 32-bit words
constexpr int QT = 8;             // queries per tile
constexpr int XS = DKW + 1;       // padded shared-memory row stride (words)
constexpr int WARPS = SEG / 32;

__global__ void __launch_bounds__(SEG)
segmin_sq8_kernel(const int8_t* __restrict__ x8,
                  const float* __restrict__ sides,
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
  const float sqn_r = sides[row];
  const float resid = sides[(long long)n_pad + row];
  const float scale = sides[2LL * n_pad + row];
  const bool keep = mv[row] != 0.f;
  const float xnorm = sqrtf(fmaxf(sqn_r, 0.f));
  float rnorm = 0.f;
  if (metric == 1 && sqn_r > 0.f) rnorm = 1.0f / sqrtf(fmaxf(sqn_r, 1e-30f));

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
      // qside rows: 0 = sq (query scale), 1 = |eq|, 2 = |q| + |eq|, 3 = q_aux
      float sq = 0.f, qe = 0.f, qne = 0.f, qaux = 0.f;
      if (q0 + j < nq) {
        const float* qsd = qside + (long long)(q0 + j) * 4;
        sq = qsd[0];
        qe = qsd[1];
        qne = qsd[2];
        qaux = qsd[3];
      }
      const float dot_mid =
          __fmul_rn(static_cast<float>(acc[j]), __fmul_rn(scale, sq));
      float err = __fadd_rn(__fmul_rn(xnorm, qe), __fmul_rn(resid, qne));
      err = __fadd_rn(__fmul_rn(err, 1.0001f), 1e-6f);
      float lb;
      if (metric == 0)
        lb = __fsub_rn(
            __fadd_rn(__fsub_rn(sqn_r, __fmul_rn(2.f, dot_mid)), qaux),
            __fmul_rn(2.f, err));
      else if (metric == 1)
        lb = __fsub_rn(1.f,
                       __fmul_rn(__fmul_rn(__fadd_rn(dot_mid, err), rnorm),
                                 qaux));
      else
        lb = -__fadd_rn(dot_mid, err);
      if (!keep) lb = __int_as_float(0x7f800000);  // +inf
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

}  // namespace

extern "C" int msdb_segmin_sq8(const int8_t* x8, const float* sides,
                               const int8_t* q8, const float* qside,
                               const float* mv, float* out, int n_pad, int d,
                               int nq, int metric, void* stream) {
  const int nseg = n_pad / SEG;
  if (nseg > 0 && nq > 0)
    segmin_sq8_kernel<<<nseg, SEG, 0, static_cast<cudaStream_t>(stream)>>>(
        x8, sides, q8, qside, mv, out, n_pad, d, nq, nseg, metric);
  return static_cast<int>(cudaGetLastError());
}
