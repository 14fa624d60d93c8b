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
// Bound on the H100: bytes, 4 x probes + 4 x build + the directory read
// once (0.16 ms at 125M probes x 10M build keys).  What holds a search back
// is not bytes but scattered loads: every lane of a warp reads another
// line, so one load instruction costs up to 32 L1 wavefronts and as many
// L2 sectors.  A plain binary search over 10M keys makes 24 of them per
// probe.
//
// Design: a radix directory (ops/kernels/merge_count.py,
// build_count_index) cuts that to about five.  Bucket j holds the keys in
// [lo + j << shift, lo + (j + 1) << shift), about one 4-key block per
// bucket and at most 2^21 buckets (8 MB, which stays in the 50 MB L2
// beside config 4's 40 MB of keys), and starts[j] is its first position.
// Per probe:
//   1. a key outside [lo, hi] misses with no load;
//   2. two loads (one line) read starts[j] and starts[j + 1];
//   3. `steps` halvings over the bucket's 4-key blocks, each comparing the
//      key with a block's last key (steps = ceil(log2) of the longest
//      bucket's block count, the same for every probe, so a warp stays in
//      step; 2 at config 4);
//   4. one 16-byte load of the block found and four compares.  A key equal
//      to the probe lies in the probe's bucket, so the keys of a block that
//      fall outside it never match.
// Each thread takes four probes with one 16-byte streaming load and runs
// their searches in lock step, so four independent chains of loads are in
// flight.  A skewed build only lengthens some buckets: `steps` then grows
// toward a plain binary search over the keys, never beyond it.  The
// directory was chosen over a static B+tree because config 4's keys are
// spread uniformly by a multiplicative hash; its build is one searchsorted
// of 2^21 + 1 edges there.  Probes are read with evict-first loads, so that
// their 500 MB stream leaves the keys and the directory in L2.  Each
// thread counts its hits, and each warp adds its total with one 64-bit
// atomicAdd.  Integer counts are exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int IMAX = 0x7fffffff;
constexpr int THREADS = 256;
constexpr int PER = 4;        // probes per thread per step: one int4 load

struct Dir {
  const int* keys;            // sorted build keys, 16-byte aligned
  int nb;
  const int* starts;          // (nbuckets + 1) bucket starts
  int lo, hi, shift, steps;
};

// how many of the first `nkeys` of the PER keys are present in the build
// (INT32_MAX by has_max)
__device__ __forceinline__ int count_keys(const Dir& d, const int (&key)[PER],
                                          bool hm, int nkeys) {
  bool live[PER];
  int base[PER], cnt[PER], end[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    live[p] = p < nkeys && key[p] >= d.lo && key[p] <= d.hi;  // hi < IMAX
    int s = 0, e = 0;
    if (live[p]) {
      const unsigned j = ((unsigned)key[p] - (unsigned)d.lo) >> d.shift;
      s = __ldg(d.starts + j);
      e = __ldg(d.starts + j + 1);
    }
    live[p] = live[p] && e > s;
    base[p] = s >> 2;
    cnt[p] = live[p] ? ((e - 1) >> 2) - base[p] + 1 : 1;
    end[p] = e;
  }
  for (int i = 0; i < d.steps; ++i) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int half = cnt[p] >> 1;
      if (live[p] && half > 0) {
        const int at = min(4 * (base[p] + half) - 1, end[p] - 1);
        if (__ldg(d.keys + at) < key[p]) base[p] += half;
      }
      cnt[p] -= half;
    }
  }
  int hits = 0;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    bool hit = p < nkeys && key[p] == IMAX && hm;
    if (live[p]) {
      const int at = 4 * base[p];
      if (at + 4 <= d.nb) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(d.keys) + base[p]);
        hit = v.x == key[p] || v.y == key[p] || v.z == key[p] ||
              v.w == key[p];
      } else {
        for (int k = at; k < d.nb; ++k)
          hit = hit || __ldg(d.keys + k) == key[p];
      }
    }
    hits += hit;
  }
  return hits;
}

__global__ void __launch_bounds__(THREADS)
merge_count_kernel(Dir d, const int* __restrict__ probe, long long n,
                   const bool* __restrict__ has_max,
                   unsigned long long* __restrict__ out) {
  const bool hm = *has_max;
  const long long n4 = n / PER;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  unsigned long long hits = 0;
  for (long long i = tid; i < n4; i += stride) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(probe) + i);
    const int key[PER] = {v.x, v.y, v.z, v.w};
    hits += count_keys(d, key, hm, PER);
  }
  if (tid == 0 && n4 * PER < n) {      // the last n % 4 probes
    const int rest = static_cast<int>(n - n4 * PER);
    int key[PER];
#pragma unroll
    for (int p = 0; p < PER; ++p) key[p] = p < rest ? probe[n4 * PER + p] : 0;
    hits += count_keys(d, key, hm, rest);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    hits += __shfl_down_sync(0xffffffffu, hits, off);
  if ((threadIdx.x & 31) == 0 && hits) atomicAdd(out, hits);
}

}  // namespace

extern "C" int msdb_merge_count(const int* build, int nb, const int* starts,
                                int lo, int hi, int shift, int steps,
                                const int* probe, long long n,
                                const bool* has_max, long long* out,
                                int blocks, void* stream) {
  if (n > 0 && blocks > 0) {
    const Dir d{build, nb, starts, lo, hi, shift, steps};
    merge_count_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        d, probe, n, has_max, reinterpret_cast<unsigned long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
