"""K4: the join count probe — how many int32 probe keys occur among the
valid build keys, with ANY semantics.

Port of myscaledb_tpu/ops/pallas/merge_count.py (``merge_count``,
``prepare_build``, ``IMAX``).  The contract is kept, the TPU layout is not:
the JAX build side is a (rows, 128) block with 2 x WIN_ROWS margin rows,
here it is one flat ascending int32 vector plus ``has_max``.

* Invalid build rows become INT32_MAX, so they never match a probe other
  than INT32_MAX itself.
* A probe equal to INT32_MAX counts exactly when a genuine valid INT32_MAX
  build key exists (``has_max``); duplicates count once per probe.
* The result is a 0-d int64 tensor on the probes' device.

The CUDA kernel (``csrc/merge_count.cu``) searches through a radix
directory over the sorted keys, ``CountIndex`` (``build_count_index``):
bucket j holds the keys in [lo + j << shift, lo + (j + 1) << shift), and
``starts[j]`` is its first position.  A probe reads its bucket's two
bounds, then a lower bound over the bucket's 4-key blocks (``steps``
halvings, the same count for every probe) and one 16-byte block compare.
The source note gives the bound on the H100.  ``merge_count_plain`` is the
same function in plain PyTorch (``torch.searchsorted``, a compare and a
sum): the wrapper uses it only for tensors on the CPU, and chip_smoke.py
holds the kernel against it on the card.  ``directory_walk`` takes the
kernel's steps in PyTorch, for the tests.  Counts are integers, so all
three are equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from myscaledb_tpu_torch.ops.kernels import build

IMAX = 2 ** 31 - 1
BLOCKS_PER_SM = 8            # grid of the kernel: one wave of 256 threads
DIR_BITS = 21                # at most 2^21 buckets: an 8 MB directory
BLOCK = 4                    # keys per 16-byte block of the in-bucket search


class CountIndex(NamedTuple):
    """Radix directory over a sorted build (``build_count_index``).

    starts: (nbuckets + 1,) int32 positions in the sorted keys; lo, hi: the
    smallest and largest valid keys below INT32_MAX; shift: bucket width
    is 2^shift keys; steps: halvings that narrow the longest bucket to one
    4-key block.  nbuckets is at most next_pow2(keys // 4) and 2^DIR_BITS,
    0 when no key below INT32_MAX exists."""
    starts: torch.Tensor
    lo: int
    hi: int
    shift: int
    steps: int

    @property
    def nbuckets(self) -> int:
        return self.starts.shape[0] - 1


def prepare_build(keys, valid=None):
    """Sort and sentinel-clean the build keys: returns (sorted (n,) int32,
    has_max 0-d bool).  Invalid rows become INT32_MAX."""
    keys = torch.as_tensor(keys).to(torch.int32)
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=keys.device)
        keys = torch.where(valid, keys, IMAX)
        has_max = (valid & (keys == IMAX)).any()
    else:
        has_max = (keys == IMAX).any()
    return torch.sort(keys).values, has_max


def build_count_index(build_sorted) -> CountIndex:
    """The kernel's directory over ``build_sorted`` (from ``prepare_build``).
    Two host synchronisations: one reads lo and hi, one the longest
    bucket."""
    dev = build_sorted.device
    empty = CountIndex(torch.zeros(1, dtype=torch.int32, device=dev),
                       0, -1, 0, 0)
    if build_sorted.shape[0] == 0:
        return empty
    # keys below INT32_MAX end where the sentinels begin
    n_real = torch.searchsorted(build_sorted, torch.tensor(
        [IMAX], dtype=torch.int32, device=dev))[0]
    n_real, lo, hi = torch.stack([
        n_real, build_sorted[0].long(),
        build_sorted[(n_real - 1).clamp(min=0)].long()]).tolist()
    if n_real == 0:
        return empty
    # about one 4-key block per bucket, at most 2^DIR_BITS buckets: a small
    # build gets a small directory, whatever its key range
    most = min(1 << DIR_BITS, 1 << max(n_real // BLOCK - 1, 0).bit_length())
    shift = 0
    while ((hi - lo) >> shift) >= most:
        shift += 1
    nbuckets = ((hi - lo) >> shift) + 1
    edges = lo + (torch.arange(nbuckets + 1, dtype=torch.int64, device=dev)
                  << shift)
    starts = torch.searchsorted(build_sorted, edges.clamp(max=IMAX)
                                .to(torch.int32)).to(torch.int32)
    s, e = starts[:-1].long(), starts[1:].long()
    blocks = torch.where(e > s, (e - 1) // BLOCK - s // BLOCK + 1, 0)
    longest = int(blocks.max())
    steps = max(longest - 1, 0).bit_length()      # ceil(log2(longest))
    return CountIndex(starts, lo, hi, shift, steps)


def _check(build_sorted, probe, has_max):
    for name, t in (("build_sorted", build_sorted), ("probe_keys", probe)):
        if t.dim() != 1:
            raise ValueError(f"merge_count: {name} must be 1-D, got shape "
                             f"{tuple(t.shape)}")
    if build_sorted.dtype != torch.int32:
        raise ValueError(f"merge_count: build_sorted must be int32, got "
                         f"{build_sorted.dtype}")
    for name, t in (("build_sorted", build_sorted), ("has_max", has_max)):
        if t.device != probe.device:
            raise ValueError(f"merge_count: {name} is on {t.device}, probe "
                             f"keys on {probe.device}")


def _has_max(has_max, device) -> torch.Tensor:
    return torch.as_tensor(has_max, dtype=torch.bool, device=device).reshape(())


def _max_extra(probe, has_max):
    """Probes equal to INT32_MAX that count: all of them when has_max."""
    n_max = (probe == IMAX).sum(dtype=torch.int64)
    return torch.where(has_max, n_max, torch.zeros_like(n_max))


def merge_count_plain(build_sorted, probe_keys, build_has_max) -> torch.Tensor:
    """Plain PyTorch version of ``merge_count``."""
    probe = torch.as_tensor(probe_keys).to(torch.int32)
    has_max = _has_max(build_has_max, probe.device)
    _check(build_sorted, probe, has_max)
    nb = build_sorted.shape[0]
    extra = _max_extra(probe, has_max)
    if nb == 0:
        return extra
    pos = torch.searchsorted(build_sorted, probe)
    hit = (pos < nb) & (build_sorted[pos.clamp(max=nb - 1)] == probe) \
        & (probe != IMAX)
    return hit.sum(dtype=torch.int64) + extra


def directory_walk(build_sorted, probe_keys, build_has_max,
                   index: CountIndex) -> torch.Tensor:
    """The kernel's search in plain PyTorch, step for step: the range test,
    the bucket's bounds, ``index.steps`` halvings over its 4-key blocks and
    the compare of the block found.  A test helper; the wrapper does not
    use it."""
    probe = torch.as_tensor(probe_keys).to(torch.int32)
    has_max = _has_max(build_has_max, probe.device)
    _check(build_sorted, probe, has_max)
    extra = _max_extra(probe, has_max)
    if index.nbuckets == 0:
        return extra
    nb = build_sorted.shape[0]
    key = probe.long()
    live = (key >= index.lo) & (key <= index.hi)         # hi < INT32_MAX
    j = torch.where(live, (key - index.lo) >> index.shift, 0)
    s = index.starts.long()[j]
    e = index.starts.long()[j + 1]
    live &= e > s
    base = s // BLOCK
    count = torch.where(live, (e - 1) // BLOCK - base + 1, 1)
    for _ in range(index.steps):
        half = count >> 1
        at = torch.minimum(BLOCK * (base + half) - 1, e - 1)
        last = build_sorted[at.clamp(0, nb - 1)].long()
        base = torch.where((half > 0) & live & (last < key), base + half,
                           base)
        count = count - half
    hit = torch.zeros_like(live)
    for lane in range(BLOCK):
        at = BLOCK * base + lane
        val = build_sorted[at.clamp(max=nb - 1)].long()
        hit |= live & (at < nb) & (val == key)
    return hit.sum(dtype=torch.int64) + extra


def index_edge_cases(seed: int = 0) -> dict:
    """Builds that stress the directory, for the tests and chip_smoke.py:
    name -> (build int32, valid bool, probe int32), numpy.
    Each probe set holds the build keys, their neighbours, keys below lo
    and above hi, INT32_MIN, INT32_MAX - 1 and INT32_MAX."""
    import numpy as np
    r = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)

    def wide(nb):
        return r.integers(i32.min, i32.max, nb, dtype=np.int64)

    # duplicates in runs of 7 on both sides of bucket edges, at positions
    # that straddle 4-key blocks: about 400 valid keys in [0, 1024) make
    # 128 buckets of 8 keys, whose edges are the multiples of 8
    edges = np.arange(8, 1024, 32)
    straddle = np.concatenate([[0, 1023], np.repeat(edges - 1, 7),
                               np.repeat(edges, 7)])
    # every key in one bucket: 20,000 keys in [0, 2048) between outliers
    # at INT32_MIN and INT32_MAX - 1 (8192 buckets of 2^19 keys), the
    # longest bucket a skewed build can make
    skew = np.concatenate([[i32.min, i32.max - 1],
                           r.integers(0, 2048, 20_000)])
    builds = {
        "nb0": np.zeros(0, np.int64),
        "nb1": np.array([5]),
        "nb2": np.array([-3, 7]),
        "nb16": wide(16),
        "nb17": wide(17),
        "nb4097": wide(4097),
        "one_bucket": skew,
        "dense": np.arange(5000),
        "extremes": np.concatenate([[i32.min, i32.min + 1, i32.max - 1, IMAX],
                                    wide(3000)]),
        "dups_straddle_edges": straddle,
        "all_invalid": wide(100),
    }
    cases = {}
    for name, build in builds.items():
        nb = len(build)
        valid = (r.random(nb) < 0.9 if name != "all_invalid"
                 else np.zeros(nb, bool))
        if name in ("extremes", "one_bucket", "dups_straddle_edges"):
            valid[:4] = True          # lo and hi stay where they were put
        near = np.concatenate([build, build - 1, build + 1]) if nb \
            else np.zeros(0, np.int64)
        probe = np.concatenate([
            near, wide(2000), [i32.min, i32.min + 1, i32.max - 1, IMAX],
            [build.min() - 1 if nb else 0, build.max() + 1 if nb else 0]])
        probe = np.clip(probe, i32.min, i32.max)
        cases[name] = (build.astype(np.int32), valid,
                       r.permutation(probe).astype(np.int32))
    return cases


def merge_count(build_sorted, probe_keys, build_has_max,
                index: CountIndex | None = None) -> torch.Tensor:
    """Count the probe keys present in the sorted build keys (ANY
    semantics).

    build_sorted: (nb,) int32 ascending, invalid rows = INT32_MAX (from
    ``prepare_build``).  probe_keys: (n,) integer keys of at most 32 bits.
    build_has_max: a genuine valid INT32_MAX build key exists (0-d bool
    tensor or Python bool).  index: the directory of ``build_sorted`` from
    ``build_count_index``; a CUDA call without one builds it first (two
    host synchronisations).  Returns a 0-d int64 tensor.  CPU tensors take
    the plain version; CUDA tensors launch the kernel.
    """
    probe = torch.as_tensor(probe_keys).to(torch.int32)
    has_max = _has_max(build_has_max, probe.device)
    _check(build_sorted, probe, has_max)
    if probe.device.type == "cpu":
        return merge_count_plain(build_sorted, probe, has_max)
    if probe.device.type != "cuda":
        raise ValueError(f"merge_count: unsupported device {probe.device}")
    nb, n = build_sorted.shape[0], probe.shape[0]
    if nb >= 2 ** 31:
        raise ValueError(f"merge_count kernel takes nb < 2^31, got {nb}")
    build_sorted = build_sorted.contiguous()
    probe = probe.contiguous()
    # 16-byte loads of build blocks and of probes
    if build_sorted.data_ptr() % 16:
        build_sorted = build_sorted.clone()
    if probe.data_ptr() % 16:
        probe = probe.clone()
    if index is None:
        index = build_count_index(build_sorted)
    elif index.starts.device != probe.device:
        raise ValueError(f"merge_count: index is on {index.starts.device}, "
                         f"probe keys on {probe.device}")
    out = torch.zeros((), dtype=torch.int64, device=probe.device)
    if n == 0:
        return out
    with torch.cuda.device(probe.device):
        sms = torch.cuda.get_device_properties(probe.device) \
            .multi_processor_count
        blocks = min(-(-n // (256 * 4)), sms * BLOCKS_PER_SM)
        rc = build.library().msdb_merge_count(
            build_sorted.data_ptr(), nb, index.starts.data_ptr(),
            index.lo, index.hi, index.shift, index.steps,
            probe.data_ptr(), n, has_max.data_ptr(), out.data_ptr(), blocks,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "merge_count")
    merge_count.launches += 1
    return out


merge_count.launches = 0
