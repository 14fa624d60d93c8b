// merge_count: how many int32 probe keys occur among the valid build keys
// (ANY semantics: a probe counts once however many build rows share its
// key).  The count is an int64 added into *out, which the wrapper zeroes.
//
// Replaces: myscaledb_tpu/ops/pallas/merge_count.py::merge_count (Pallas
// body `_kernel`, driven by `_merge_count_jit`).  The contract is kept, the
// TPU design is not: the (rows, 128) layout, the 2 x WIN_ROWS margin, the
// chunk sort of the probes and the lane-roll sweeps exist because the TPU
// has no gather.  Here the build side is one flat ascending int32 vector in
// which invalid rows hold INT32_MAX, and `has_max` (a device bool) says
// whether a genuine valid INT32_MAX build key exists.  A probe equal to
// INT32_MAX counts exactly when has_max is set; every other probe counts
// when its key is in the vector.  The correction is applied here, on the
// device, with no host synchronisation.
//
// Bound on the H100: bytes, 4 x probes + 4 x build read once (0.16 ms at
// 125M probes x 10M build keys).  The kernel is far from it: each probe does
// ceil(log2(nb)) dependent loads of a binary search.  At config 4's 10M
// build keys (40 MB) the vector fits the 50 MB L2, and the top levels of
// the search tree stay in L1, so the searches run from cache, not HBM.
//
// Design (simple first): a grid-stride loop, one thread per probe per
// step.  Each thread runs a branchless lower bound (the trip count depends
// on nb alone, so a warp's threads stay in step), a warp ballot and a
// popcount count the warp's hits, and each warp adds its total with one
// 64-bit atomicAdd at the end.  Integer counts are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IMAX = 0x7fffffff;
constexpr int THREADS = 256;

// true when key is in the ascending vector b[0..nb) (nb >= 1)
__device__ __forceinline__ bool contains(const int* __restrict__ b, int nb,
                                         int key) {
  const int* base = b;
  int len = nb;
  while (len > 1) {
    const int half = len >> 1;
    base = (__ldg(base + half) < key) ? base + half : base;
    len -= half;
  }
  // the lower bound is base + (*base < key)
  const int v = __ldg(base);
  if (v == key) return true;
  return v < key && base + 1 < b + nb && __ldg(base + 1) == key;
}

__global__ void __launch_bounds__(THREADS)
merge_count_kernel(const int* __restrict__ build, int nb,
                   const int* __restrict__ probe, long long n,
                   const bool* __restrict__ has_max,
                   unsigned long long* __restrict__ out) {
  const bool hm = *has_max;
  const long long stride = (long long)gridDim.x * THREADS;
  unsigned long long hits = 0;  // the warp's total, kept by every lane
  // every lane of a warp makes the same number of trips: the bound of the
  // loop is rounded up to whole warps, and lanes past n count nothing
  const long long n_warps = (n + 31) & ~31LL;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < n_warps; i += stride) {
    bool hit = false;
    if (i < n) {
      const int key = probe[i];
      hit = key == IMAX ? hm : (nb > 0 && contains(build, nb, key));
    }
    hits += __popc(__ballot_sync(0xffffffffu, hit));
  }
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(out, hits);
}

}  // namespace

extern "C" int msdb_merge_count(const int* build, int nb, const int* probe,
                                long long n, const bool* has_max,
                                long long* out, int blocks, void* stream) {
  if (n > 0 && blocks > 0)
    merge_count_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        build, nb, probe, n, has_max,
        reinterpret_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
