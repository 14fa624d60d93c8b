// binary_segmin: for each 1024-row segment and each query, the minimum
// binary-vector distance over the segment's live rows, as f32:
//   Hamming  popcount(x ^ q) summed over the row's words
//   Jaccard  (union - inter) / union, union = popcount(x | q),
//            inter = popcount(x & q); 1 when the union is empty
// Rows >= n, and rows whose mask byte is 0 when has_mask is set, give
// +inf.  Output (nseg, nq).
//
// Replaces: myscaledb_tpu/ops/pallas/binary_scan.py::binary_segment_mins
// (Pallas body `_segmin_kernel`).  The input keeps the segment-major layout
// (nseg, words, 1024): a segment's rows are contiguous per word, so a
// warp's loads of one word coalesce, and each segment is a contiguous row
// range, which the rescore's exactness proof needs (ops/binary_vector.py).
//
// Bound on the H100: bytes.  The table is read once, nseg * 1024 *
// (4 words + 1 mask byte); at config 6 (16M rows, 8 words) that is 0.55 GB,
// 0.16 ms at 3.35 TB/s.  The popcounts (2-3 integer ops per word, row and
// query) stay below the integer rate up to a few dozen queries.
//
// Design (simple first): one 1024-thread block per segment, one thread per
// row.  A thread keeps its row's first MAXW words in registers (the words
// of a wider row past MAXW are re-read from L1 for each query) and loops
// over the queries, staged in shared memory in chunks.  Per query, a warp
// takes its minimum with shuffles, and the block's 32 warp minima are
// combined for QG queries at a time.  Integer scores and a float minimum
// are exact in any order, and the Jaccard quotient is the IEEE division
// (__fdiv_rn), so the result is bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 1024;          // rows per segment == threads per block
constexpr int WARPS = SEG / 32;
constexpr int MAXW = 16;           // words kept in registers
constexpr int QG = 8;              // queries reduced across warps at a time

// Popcounts of one word pair: Hamming a += |x ^ y|; Jaccard a += |x & y|
// (intersection), b += |x | y| (union).
__device__ __forceinline__ void count_word(uint32_t x, uint32_t y,
                                           int jaccard, int& a, int& b) {
  if (jaccard) {
    a += __popc(x & y);
    b += __popc(x | y);
  } else {
    a += __popc(x ^ y);
  }
}

__global__ void __launch_bounds__(SEG)
binary_segmin_kernel(const uint32_t* __restrict__ x3,
                     const uint32_t* __restrict__ qw,
                     const uint8_t* __restrict__ mask2,
                     float* __restrict__ out, int words, int nq, long long n,
                     int has_mask, int jaccard, int qchunk) {
  extern __shared__ uint32_t qs[];  // qchunk x words query words
  __shared__ float red[WARPS][QG];

  const int t = threadIdx.x;
  const int seg = blockIdx.x;
  const long long row = (long long)seg * SEG + t;
  bool live = row < n;
  if (has_mask) live = live && mask2[row] != 0;
  // word w of this thread's row is xr[w * SEG]
  const uint32_t* xr = x3 + (long long)seg * words * SEG + t;
  uint32_t xreg[MAXW];
#pragma unroll
  for (int w = 0; w < MAXW; ++w) xreg[w] = w < words ? xr[w * SEG] : 0u;

  for (int q0 = 0; q0 < nq; q0 += qchunk) {
    const int qn = min(qchunk, nq - q0);
    __syncthreads();  // readers of the previous chunk are done
    for (int e = t; e < qn * words; e += SEG)
      qs[e] = qw[(long long)q0 * words + e];
    __syncthreads();
    for (int j = 0; j < qn; ++j) {
      const uint32_t* q = qs + j * words;
      int a = 0, b = 0;  // Hamming: a = xor count; Jaccard: a = inter, b = union
#pragma unroll
      for (int w = 0; w < MAXW; ++w)
        if (w < words) count_word(xreg[w], q[w], jaccard, a, b);
      for (int w = MAXW; w < words; ++w)
        count_word(xr[w * SEG], q[w], jaccard, a, b);
      float s;
      if (!jaccard)
        s = __int2float_rn(a);
      else
        s = b > 0 ? __fdiv_rn(__int2float_rn(b - a), __int2float_rn(b)) : 1.f;
      if (!live) s = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = fminf(s, __shfl_xor_sync(0xffffffffu, s, off));
      const int g = j % QG;
      if ((t & 31) == 0) red[t >> 5][g] = s;
      if (g == QG - 1 || j == qn - 1) {
        __syncthreads();
        if (t <= g) {
          float m = red[0][t];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) m = fminf(m, red[w][t]);
          out[(long long)seg * nq + q0 + (j - g) + t] = m;
        }
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" int msdb_binary_segmin(const uint32_t* x3, const uint32_t* qw,
                                  const uint8_t* mask2, float* out, int nseg,
                                  int words, int nq, long long n, int has_mask,
                                  int jaccard, int qchunk, void* stream) {
  if (nseg > 0 && nq > 0 && words > 0) {
    const size_t smem = (size_t)qchunk * words * sizeof(uint32_t);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    binary_segmin_kernel<<<nseg, SEG, smem, s>>>(
        x3, qw, mask2, out, words, nq, n, has_mask, jaccard, qchunk);
  }
  return static_cast<int>(cudaGetLastError());
}
