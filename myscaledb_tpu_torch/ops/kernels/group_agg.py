"""K3: grouped count and sums for G <= 256 groups under a row mask.

Port of myscaledb_tpu/ops/pallas/group_agg.py (``pallas_group_aggregate``,
``MAX_G``).  The CUDA kernel is ``csrc/group_agg.cu``; its note gives the
bound on the H100 and the design.  ``group_aggregate_plain`` is the same
function in plain PyTorch: the wrapper uses it only for tensors on the
CPU, and chip_smoke.py holds the kernel against it on the card.

Both keep the JAX signature and its dedupe: identical (kind, argument)
pairs — ``sum(v)`` and ``avg(v)`` — are accumulated once and fanned back
out to the caller's order.  An argument is identified by its storage
(device, dtype, data pointer, shape, strides), so two evaluations of one
column reference share a slot even when they are different tensor objects.
``arg_ranges`` (zone-map bounds, which pick the TPU kernel's single-limb
path) are accepted and ignored: the CUDA kernel sums int32 into int64
directly.
"""

from __future__ import annotations

import ctypes

import torch

from myscaledb_tpu_torch.ops.kernels import build

MAX_G = 256
MAX_ARGS = 8                 # unique arguments per launch (csrc MAX_ARGS)
TILE = 8 * 128               # rows one sweep of a block's 8 warps loads
MAX_BLOCKS = 1024


def grid(n: int) -> tuple[int, int]:
    """(nblocks, rows_per_block) of the kernel for n rows: contiguous
    stretches, a whole number of sweeps each.  Depends on n alone, so the
    float summation order is fixed for a given input size."""
    nb = min(-(-n // TILE), MAX_BLOCKS)
    per_block = -(-n // nb)
    rows = -(-per_block // TILE) * TILE
    return -(-n // rows), rows


def _dedupe(args, kinds):
    """Unique (kind, argument) slots: returns (kinds, args cast to int32 or
    float32, slot per original argument or None for count)."""
    uniq, slot_of, u_kinds, u_args = {}, [], [], []
    for k, a in zip(kinds, args):
        if k == "count":
            slot_of.append(None)
            continue
        if k not in ("int", "float"):
            raise ValueError(f"group_aggregate: unknown kind {k!r}")
        t = torch.as_tensor(a)
        key = (k, t.device, t.dtype, t.data_ptr(), tuple(t.shape),
               tuple(t.stride()))
        if key not in uniq:
            uniq[key] = len(u_kinds)
            u_kinds.append(k)
            u_args.append(t.to(torch.float32 if k == "float"
                               else torch.int32).contiguous())
        slot_of.append(uniq[key])
    return u_kinds, u_args, slot_of


def _check(gid, mask, args, num_groups):
    if not 1 <= num_groups <= MAX_G:
        raise ValueError(f"group_aggregate: num_groups = {num_groups}, must "
                         f"be in [1, {MAX_G}]")
    n = gid.shape[0]
    for name, t in [("gid", gid), ("mask", mask)] + [
            (f"args[{i}]", a) for i, a in enumerate(args) if a is not None]:
        if tuple(t.shape) != (n,):
            raise ValueError(f"group_aggregate: {name} has shape "
                             f"{tuple(t.shape)}, expected ({n},)")
        if t.device != gid.device:
            raise ValueError(f"group_aggregate: {name} is on {t.device}, "
                             f"gid on {gid.device}")


def _zeros(kinds, G, device):
    zi = torch.zeros(G, dtype=torch.int64, device=device)
    zf = torch.zeros(G, dtype=torch.float32, device=device)
    return tuple(zf if k == "float" else zi for k in kinds), zi, \
        tuple(zi for _ in kinds)


def _fan_out(count, u_states, slot_of):
    states = tuple(count if s is None else u_states[s] for s in slot_of)
    return states, count, tuple(count for _ in slot_of)


def _accumulate_plain(gid, mask, u_args, u_kinds, G):
    sel = mask.bool() & (gid >= 0) & (gid < G)
    tgt = torch.where(sel, gid.long(), G)
    count = torch.bincount(tgt, minlength=G + 1)[:G]
    sums = []
    for k, a in zip(u_kinds, u_args):
        dt = torch.float64 if k == "float" else torch.int64
        s = torch.zeros(G + 1, dtype=dt, device=gid.device) \
            .index_add_(0, tgt, a.to(dt))[:G]
        sums.append(s.to(torch.float32) if k == "float" else s)
    return count, sums


def group_aggregate_plain(gid, mask, args, kinds: tuple, num_groups: int,
                          arg_ranges=None):
    """Plain PyTorch version of ``group_aggregate``: the same dedupe and
    result, with bincount/index_add_.  Float sums are taken in f64 and
    rounded to f32 once, so the reference is no less accurate than the
    kernel whatever order index_add_ adds in."""
    _check(gid, mask, args, num_groups)
    if gid.shape[0] == 0:
        return _zeros(kinds, num_groups, gid.device)
    u_kinds, u_args, slot_of = _dedupe(args, kinds)
    count, u_states = _accumulate_plain(gid, mask, u_args, u_kinds,
                                        num_groups)
    return _fan_out(count, u_states, slot_of)


def _accumulate_cuda(gid, mask, u_args, u_kinds, G):
    n = gid.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"group_aggregate kernel takes n < 2^31, got {n}")
    dev = gid.device
    gid = gid.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    nblocks, rows = grid(n)
    lib = build.library()
    count, sums = None, []
    for lo in range(0, max(len(u_args), 1), MAX_ARGS):
        kinds = u_kinds[lo:lo + MAX_ARGS]
        args = u_args[lo:lo + MAX_ARGS]
        na = len(args)
        float_bits = sum(1 << i for i, k in enumerate(kinds) if k == "float")
        part_i = torch.empty((nblocks, 1 + na, G), dtype=torch.int64,
                             device=dev)
        part_f = torch.empty((nblocks, max(na, 1), G), dtype=torch.float32,
                             device=dev)
        out_i = torch.empty((1 + na, G), dtype=torch.int64, device=dev)
        out_f = torch.empty((max(na, 1), G), dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * MAX_ARGS)(*[a.data_ptr() for a in args])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.msdb_group_agg(
                gid.data_ptr(), mask.data_ptr(), ptrs, na, float_bits, n, G,
                nblocks, rows, part_i.data_ptr(), part_f.data_ptr(),
                out_i.data_ptr(), out_f.data_ptr(), stream)
        build.check(rc, "group_aggregate")
        group_aggregate.launches += 1
        if count is None:
            count = out_i[0]
        sums.extend(out_f[i] if k == "float" else out_i[1 + i]
                    for i, k in enumerate(kinds))
    return count, sums


def group_aggregate(gid, mask, args, kinds: tuple, num_groups: int,
                    arg_ranges=None):
    """Grouped sums and counts (the JAX ``pallas_group_aggregate``).

    gid (n,) int group ids, mask (n,) bool; args per aggregate: an (n,)
    int/bool tensor for kind "int" (exact int64 sum), float for "float"
    (f32 sum), anything (None) for "count".  num_groups <= 256.  Rows with
    mask false or a gid outside [0, num_groups) count nowhere.  Returns
    (states, group_count, arg_counts); arg_counts == group_count (callers
    with per-argument validity take the matmul path).  CPU tensors take the
    plain version; CUDA tensors launch the kernel, once per 8 unique
    arguments.
    """
    _check(gid, mask, args, num_groups)
    if gid.shape[0] == 0:
        return _zeros(kinds, num_groups, gid.device)
    u_kinds, u_args, slot_of = _dedupe(args, kinds)
    if gid.device.type == "cpu":
        count, u_states = _accumulate_plain(gid, mask, u_args, u_kinds,
                                            num_groups)
    elif gid.device.type == "cuda":
        count, u_states = _accumulate_cuda(gid, mask, u_args, u_kinds,
                                           num_groups)
    else:
        raise ValueError(f"group_aggregate: unsupported device {gid.device}")
    return _fan_out(count, u_states, slot_of)


group_aggregate.launches = 0
