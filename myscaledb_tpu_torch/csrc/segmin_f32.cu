// segmin_f32: per query and per 128-row segment, the minimum of the f32
// selection score of the exact two-stage vector scan.
//
// Replaces: myscaledb_tpu/ops/pallas/distance.py::fused_segmin_scores
// (Pallas body `_kernel`).  Scores, for dot = x_row . q in IEEE f32:
//   L2      sqn - 2 dot + q_aux            (q_aux = |q|^2)
//   Cosine  1 - dot * rnorm(sqn) * q_aux   (q_aux = 1/|q|, rnorm = 1/sqrt)
//   IP      -dot
// Rows with mask == 0 and rows >= n score +inf.  Output (nq, ceil(n/128)).
//
// Bound on the H100: memory.  Each x row is read once, plus sqn and the f32
// mask: (4 d + 8) bytes per row, 520 MB at n = 1M, d = 128, i.e. ~155 us
// at 3.35 TB/s.  The FLOPs (2 nq d per row) stay below the f32 rate for
// nq <= 128.
//
// Design (simple first, no wgmma/TMA yet): one 128-thread block per
// segment and one thread per row.  The block stages a 128 x 32 chunk of x
// in shared memory with coalesced 16-byte loads (padded row stride 33, so
// the per-row reads are free of bank conflicts) and a 32 x 8 chunk of the
// queries, which every thread reads as broadcast float4s.  Each thread keeps
// 8 query accumulators in registers (fmaf, IEEE f32: no TF32), so nq > 8
// runs several query tiles over the segment; those re-reads of x hit L2.
// The epilogue applies the metric formula, the mask and the row bound with
// round-to-nearest intrinsics (no FMA contraction, so it matches the plain
// PyTorch version up to the order of the dot sums) and reduces the segment
// minimum with warp shuffles plus one shared-memory step.  x is never
// padded: rows past n are masked in the kernel.  Cosine uses 1.0f/sqrtf
// (correctly rounded), not the approximate rsqrtf.

#include <cuda_runtime.h>

namespace {

constexpr int SEG = 128;      // rows per segment == threads per block
constexpr int DK = 32;        // feature dims staged per chunk
constexpr int QT = 8;         // queries per tile (accumulators per thread)
constexpr int XS = DK + 1;    // padded shared-memory row stride
constexpr int WARPS = SEG / 32;

__global__ void __launch_bounds__(SEG)
segmin_f32_kernel(const float* __restrict__ x, const float* __restrict__ q,
                  const float* __restrict__ sqn,
                  const float* __restrict__ qaux,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int n, int d, int nq, int nseg, int metric) {
  __shared__ float xs[SEG * XS];
  __shared__ __align__(16) float qs[DK * QT];
  __shared__ float red[WARPS][QT];

  const int t = threadIdx.x;
  const int seg = blockIdx.x;
  const long long row0 = (long long)seg * SEG;
  const long long row = row0 + t;
  bool keep = row < n;
  float sq = 0.f;
  if (keep) {
    sq = sqn[row];
    if (mask != nullptr) keep = mask[row] != 0.f;
  }
  float rnorm = 0.f;
  if (metric == 1 && sq > 0.f) rnorm = 1.0f / sqrtf(fmaxf(sq, 1e-30f));

  for (int q0 = 0; q0 < nq; q0 += QT) {
    float acc[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += DK) {
      __syncthreads();  // readers of the previous chunk are done
      // x chunk: SEG rows x DK floats, 8 float4 per thread; 8 consecutive
      // threads read one row's 128 contiguous bytes
#pragma unroll
      for (int p = 0; p < (SEG * DK / 4) / SEG; ++p) {
        const int f = t + p * SEG;
        const int r = f / (DK / 4);
        const int c4 = f % (DK / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < n)
          v = *reinterpret_cast<const float4*>(x + (row0 + r) * d + k0 +
                                               c4 * 4);
        float* dst = xs + r * XS + c4 * 4;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
      // query chunk, k-major: qs[k * QT + j]
      for (int e = t; e < QT * DK; e += SEG) {
        const int j = e / DK;
        const int k = e % DK;
        qs[k * QT + j] =
            (q0 + j < nq) ? q[(long long)(q0 + j) * d + k0 + k] : 0.f;
      }
      __syncthreads();
      const float* xr = xs + t * XS;
#pragma unroll 8
      for (int k = 0; k < DK; ++k) {
        const float xv = xr[k];
        const float4 qa = *reinterpret_cast<const float4*>(qs + k * QT);
        const float4 qb = *reinterpret_cast<const float4*>(qs + k * QT + 4);
        acc[0] = fmaf(xv, qa.x, acc[0]);
        acc[1] = fmaf(xv, qa.y, acc[1]);
        acc[2] = fmaf(xv, qa.z, acc[2]);
        acc[3] = fmaf(xv, qa.w, acc[3]);
        acc[4] = fmaf(xv, qb.x, acc[4]);
        acc[5] = fmaf(xv, qb.y, acc[5]);
        acc[6] = fmaf(xv, qb.z, acc[6]);
        acc[7] = fmaf(xv, qb.w, acc[7]);
      }
    }

#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const float dot = acc[j];
      const float qa = (q0 + j < nq) ? qaux[q0 + j] : 0.f;
      float s;
      if (metric == 0)
        s = __fadd_rn(__fsub_rn(sq, __fmul_rn(2.f, dot)), qa);
      else if (metric == 1)
        s = __fsub_rn(1.f, __fmul_rn(__fmul_rn(dot, rnorm), qa));
      else
        s = -dot;
      if (!keep) s = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = fminf(s, __shfl_xor_sync(0xffffffffu, s, off));
      if ((t & 31) == 0) red[t >> 5][j] = s;
    }
    __syncthreads();
    if (t < QT && q0 + t < nq) {
      float m = red[0][t];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) m = fminf(m, red[w][t]);
      out[(long long)(q0 + t) * nseg + seg] = m;
    }
    // the next tile's first __syncthreads() orders these reads of `red`
    // before its writes
  }
}

}  // namespace

extern "C" int msdb_segmin_f32(const float* x, const float* q,
                               const float* sqn, const float* qaux,
                               const float* mask, float* out, int n, int d,
                               int nq, int metric, void* stream) {
  const int nseg = (n + SEG - 1) / SEG;
  if (nseg > 0 && nq > 0)
    segmin_f32_kernel<<<nseg, SEG, 0, static_cast<cudaStream_t>(stream)>>>(
        x, q, sqn, qaux, mask, out, n, d, nq, nseg, metric);
  return static_cast<int>(cudaGetLastError());
}
