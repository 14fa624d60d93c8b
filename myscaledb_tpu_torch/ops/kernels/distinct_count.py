"""K6: the exact number of distinct keys per group among the selected
rows — ``count(DISTINCT x) ... GROUP BY`` for one integer key.

It replaces no TPU kernel: the JAX package counts distinct tuples by a
sort and its run starts, and so did the port
(``sql/agg_fns.py::_distinct_first_hit``).  The CUDA kernel
(``csrc/distinct_count.cu``) inserts every selected (group, key) tuple
into one hash set in device memory and counts the inserts that claim a
new slot; its note gives the bound on the H100 and the design.
``distinct_count_plain`` is the sort-based count in plain PyTorch: the
wrapper uses it only for tensors on the CPU, and the card tests hold the
kernel against it.  Counts are integers, so the two are equal.

The table has ``capacity(n)`` slots of 16 bytes: a power of two at a load
of at most 0.5 for n rows, known on the host without a sync (2^28 slots,
4.3 GB, at 100M rows).  Its bytes are charged to the query's memory
budget.
"""

from __future__ import annotations

import torch

from myscaledb_tpu_torch.ops.hashtable import _sorted_runs
from myscaledb_tpu_torch.ops.kernels import build
from myscaledb_tpu_torch.runtime.memory import charge

SLOT_BYTES = 16
MIN_CAPACITY = 64
# key dtypes by width: the kernel sign-extends each width to 64 bits, an
# injective widening whatever the dtype's signedness
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def capacity(n: int) -> int:
    """Slots of the table for n rows: the least power of two >= 2n."""
    c = MIN_CAPACITY
    while c < 2 * n:
        c <<= 1
    return c


def _check(gid, key, mask, num_groups):
    if not 1 <= num_groups < 2 ** 31:
        raise ValueError(f"distinct_count: num_groups = {num_groups}, must "
                         "be in [1, 2^31)")
    if key.dim() != 1 or key.is_floating_point() or key.is_complex() \
            or key.element_size() not in _SIGNED:
        raise ValueError(f"distinct_count: key must be a 1-D integer tensor "
                         f"of 1 to 8 bytes, got {key.dtype} of shape "
                         f"{tuple(key.shape)}")
    n = key.shape[0]
    for name, t in (("gid", gid), ("mask", mask)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"distinct_count: {name} has shape "
                             f"{tuple(t.shape)}, expected ({n},)")
        if t.device != key.device:
            raise ValueError(f"distinct_count: {name} is on {t.device}, key "
                             f"on {key.device}")


def distinct_count_plain(gid, key, mask, num_groups: int) -> torch.Tensor:
    """Plain PyTorch version of ``distinct_count``: one stable sort by
    (valid, group, key) (``ops/hashtable.py::_sorted_runs``), then a
    bincount of the run starts' groups."""
    _check(gid, key, mask, num_groups)
    G = num_groups
    if key.shape[0] == 0:
        return torch.zeros(G, dtype=torch.int64, device=key.device)
    sel = mask.to(torch.bool) & (gid >= 0) & (gid < G)
    _g, _ng, _perm, s_keys, is_start, _run = _sorted_runs((gid, key), sel)
    groups = s_keys[0][is_start].to(torch.int64)
    return torch.bincount(groups, minlength=G)[:G]


def _count_cuda(gid, key, mask, G, cap, check_overflow):
    n = key.shape[0]
    dev = key.device
    gid = gid.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    key = key.contiguous().view(_SIGNED[key.element_size()])
    table = torch.empty((cap, 2), dtype=torch.int64, device=dev)
    counts = torch.empty(G, dtype=torch.int64, device=dev)
    overflow = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().msdb_distinct_count(
            gid.data_ptr(), key.data_ptr(), key.element_size(),
            mask.data_ptr(), n, G, table.data_ptr(), cap, counts.data_ptr(),
            overflow.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "distinct_count")
    distinct_count.launches += 1
    if check_overflow and int(overflow[0]):
        raise RuntimeError(f"distinct_count: more distinct tuples than the "
                           f"{cap} slots of the table")
    return counts


def distinct_count(gid, key, mask, num_groups: int,
                   capacity_slots: int | None = None) -> torch.Tensor:
    """Per group, the number of distinct keys among the selected rows.

    gid (n,) int group ids, key (n,) integer of 1 to 8 bytes (integers,
    dictionary ids, float bit keys), mask (n,) bool.  Rows with mask false
    or a gid outside [0, num_groups) count nowhere.  Returns (num_groups,)
    int64 on the key's device.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, once a call.  ``capacity_slots`` (a power
    of two) replaces the table's size, for tests: a call given one reads
    the kernel's overflow flag back and raises if the table was too
    small; the default size cannot overflow and reads nothing back.
    """
    _check(gid, key, mask, num_groups)
    n = key.shape[0]
    cap = capacity(n) if capacity_slots is None else int(capacity_slots)
    if cap < 2 or cap & (cap - 1):
        raise ValueError(f"distinct_count: capacity {cap} is not a power "
                         "of two")
    charge(cap * SLOT_BYTES, "distinct_hash")
    if key.device.type == "cpu":
        return distinct_count_plain(gid, key, mask, num_groups)
    if key.device.type != "cuda":
        raise ValueError(f"distinct_count: unsupported device {key.device}")
    if n == 0:
        return torch.zeros(num_groups, dtype=torch.int64, device=key.device)
    return _count_cuda(gid, key, mask, num_groups, cap,
                       capacity_slots is not None)


distinct_count.launches = 0
