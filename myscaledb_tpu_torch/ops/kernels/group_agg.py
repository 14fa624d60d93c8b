"""K3: grouped count, sums, min and max for G <= 256 groups under a row
mask.

Port of myscaledb_tpu/ops/pallas/group_agg.py (``pallas_group_aggregate``,
``MAX_G``), which takes counts and sums; the "min" and "max" kinds take what
myscaledb_tpu/ops/aggregate.py::partial_aggregate computes by scatter for
integer arguments.  The CUDA kernel is ``csrc/group_agg.cu``; its note
gives the bound on the H100 and the design.  ``group_aggregate_plain`` is
the same function in plain PyTorch: the wrapper uses it only for tensors
on the CPU, and chip_smoke.py holds the kernel against it on the card.

Both keep the JAX signature and its dedupe: identical (kind, argument)
pairs — ``sum(v)`` and ``avg(v)`` — are accumulated once and fanned back
out to the caller's order.  An argument is identified by its storage
(device, dtype, data pointer, shape, strides) and the type it is loaded as
(int32, int64 or f32), so two evaluations of one column reference share a
load even when they are different tensor objects, and ``min(v)``,
``max(v)`` and ``sum(v)`` read v once.  ``arg_ranges`` (zone-map bounds,
which pick the TPU kernel's single-limb path) are accepted and ignored:
the CUDA kernel sums int32 into int64 directly.
"""

from __future__ import annotations

import ctypes

import torch

from myscaledb_tpu_torch.ops.kernels import build

MAX_G = 256
MAX_ARGS = 8                 # unique arguments per launch (csrc MAX_ARGS)
MAX_LANES = 8                # sum/min/max lanes per launch (csrc)
TILE = 8 * 128               # rows one sweep of a block's 8 warps loads
MAX_BLOCKS = 1024
# storage dtypes the min/max lanes take: loaded as int32, or int64 as is
MINMAX_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.uint8)
_LANE_CODE = {"int": 0, "float": 0, "min": 1, "max": 2}


def grid(n: int) -> tuple[int, int]:
    """(nblocks, rows_per_block) of the kernel for n rows: contiguous
    stretches, a whole number of sweeps each.  Depends on n alone, so the
    float summation order is fixed for a given input size."""
    nb = min(-(-n // TILE), MAX_BLOCKS)
    per_block = -(-n // nb)
    rows = -(-per_block // TILE) * TILE
    return -(-n // rows), rows


def _load_dtype(kind: str, t: torch.Tensor) -> torch.dtype:
    if kind == "float":
        return torch.float32
    if kind in ("min", "max"):
        if t.dtype not in MINMAX_DTYPES:
            raise ValueError(f"group_aggregate: {kind} takes an integer "
                             f"argument, got {t.dtype}")
        return torch.int64 if t.dtype == torch.int64 else torch.int32
    return torch.int32


def _dedupe(args, kinds):
    """Unique loaded arguments and their lanes: returns (lanes, args cast to
    their load type, lane per original aggregate or None for count).  A
    lane is (kind, argument index, result dtype): int64 for an int sum, f32
    for a float sum, the argument's own dtype for a min or max.  Lanes come
    grouped by argument, so a launch of MAX_LANES lanes keeps an
    argument's lanes together where it can."""
    arg_of, seen, u_args, by_arg, keys = {}, set(), [], [], []
    for k, a in zip(kinds, args):
        if k == "count":
            keys.append(None)
            continue
        if k not in _LANE_CODE:
            raise ValueError(f"group_aggregate: unknown kind {k!r}")
        t = torch.as_tensor(a)
        load = _load_dtype(k, t)
        akey = (t.device, t.dtype, t.data_ptr(), tuple(t.shape),
                tuple(t.stride()), load)
        if akey not in arg_of:
            arg_of[akey] = len(u_args)
            u_args.append(t.to(load).contiguous())
            by_arg.append([])
        ai = arg_of[akey]
        if (k, ai) not in seen:
            seen.add((k, ai))
            by_arg[ai].append((k, ai, t.dtype if k in ("min", "max")
                               else torch.float32 if k == "float"
                               else torch.int64))
        keys.append((k, ai))
    lanes = [ln for group in by_arg for ln in group]
    lane_of = {(k, ai): i for i, (k, ai, _d) in enumerate(lanes)}
    return lanes, u_args, [None if key is None else lane_of[key]
                           for key in keys]


def _init(kind: str, dtype: torch.dtype) -> int:
    """Where a min/max lane starts: the storage dtype's largest value for a
    min, its smallest for a max (what an empty group gives)."""
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


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


def _zeros(lanes, G, device):
    """(count, lane states) over no rows."""
    count = torch.zeros(G, dtype=torch.int64, device=device)
    return count, [torch.full((G,), _init(k, d), dtype=d, device=device)
                   if k in ("min", "max")
                   else torch.zeros(G, dtype=d, device=device)
                   for k, _a, d in lanes]


def _fan_out(count, u_states, slot_of):
    states = tuple(count if s is None else u_states[s] for s in slot_of)
    return states, count, tuple(count for _ in slot_of)


def _accumulate_plain(gid, mask, u_args, lanes, G):
    sel = mask.bool() & (gid >= 0) & (gid < G)
    tgt = torch.where(sel, gid.long(), G)
    count = torch.bincount(tgt, minlength=G + 1)[:G]
    states = []
    for k, ai, d in lanes:
        a = u_args[ai]
        if k in ("min", "max"):
            s = torch.full((G + 1,), _init(k, d), dtype=a.dtype,
                           device=gid.device).scatter_reduce_(
                0, tgt, a, "amin" if k == "min" else "amax")[:G]
            states.append(s.to(d))
            continue
        dt = torch.float64 if k == "float" else torch.int64
        s = torch.zeros(G + 1, dtype=dt, device=gid.device) \
            .index_add_(0, tgt, a.to(dt))[:G]
        states.append(s.to(torch.float32) if k == "float" else s)
    return count, states


def group_aggregate_plain(gid, mask, args, kinds: tuple, num_groups: int,
                          arg_ranges=None):
    """Plain PyTorch version of ``group_aggregate``: the same dedupe and
    result, with bincount/index_add_/scatter_reduce_.  Float sums are taken
    in f64 and rounded to f32 once, so the reference is no less accurate
    than the kernel whatever order index_add_ adds in."""
    _check(gid, mask, args, num_groups)
    lanes, u_args, slot_of = _dedupe(args, kinds)
    if gid.shape[0] == 0:
        return _fan_out(*_zeros(lanes, num_groups, gid.device), slot_of)
    count, u_states = _accumulate_plain(gid, mask, u_args, lanes, num_groups)
    return _fan_out(count, u_states, slot_of)


def _accumulate_cuda(gid, mask, u_args, lanes, G):
    n = gid.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"group_aggregate kernel takes n < 2^31, got {n}")
    dev = gid.device
    gid = gid.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    nblocks, rows = grid(n)
    lib = build.library()
    count, states = None, []
    for lo in range(0, max(len(lanes), 1), MAX_LANES):
        chunk = lanes[lo:lo + MAX_LANES]
        arg_ids = list(dict.fromkeys(ai for _k, ai, _d in chunk))
        args = [u_args[ai] for ai in arg_ids]
        na, nl = len(args), len(chunk)
        float_bits = sum(1 << i for i, a in enumerate(args)
                         if a.dtype == torch.float32)
        part_i = torch.empty((nblocks, 1 + nl, G), dtype=torch.int64,
                             device=dev)
        part_f = torch.empty((nblocks, max(nl, 1), G), dtype=torch.float32,
                             device=dev)
        out_i = torch.empty((1 + nl, G), dtype=torch.int64, device=dev)
        out_f = torch.empty((max(nl, 1), G), dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * MAX_ARGS)(*[a.data_ptr() for a in args])
        wide_bits = sum(1 << i for i, a in enumerate(args)
                        if a.dtype == torch.int64)
        lane_arg = (ctypes.c_byte * MAX_LANES)(
            *[arg_ids.index(ai) for _k, ai, _d in chunk])
        lane_kind = (ctypes.c_byte * MAX_LANES)(
            *[_LANE_CODE[k] for k, _a, _d in chunk])
        init = (ctypes.c_longlong * MAX_LANES)(
            *[_init(k, d) if k in ("min", "max") else 0
              for k, _a, d in chunk])
        with torch.cuda.device(dev):
            rc = lib.msdb_group_agg(
                gid.data_ptr(), mask.data_ptr(), ptrs, na, float_bits,
                wide_bits, lane_arg, lane_kind, init, nl, n, G, nblocks,
                rows, part_i.data_ptr(), part_f.data_ptr(), out_i.data_ptr(),
                out_f.data_ptr(), torch.cuda.current_stream().cuda_stream)
        build.check(rc, "group_aggregate")
        group_aggregate.launches += 1
        if count is None:
            count = out_i[0]
        for i, (k, _a, d) in enumerate(chunk):
            if k == "float":
                states.append(out_f[i])
            elif k == "int":
                states.append(out_i[1 + i])
            else:
                states.append(out_i[1 + i].to(d))
    return count, states


def group_aggregate(gid, mask, args, kinds: tuple, num_groups: int,
                    arg_ranges=None):
    """Grouped counts, sums, mins and maxes (the JAX
    ``pallas_group_aggregate``, plus min and max).

    gid (n,) int group ids, mask (n,) bool; args per aggregate: an (n,)
    int/bool tensor for kind "int" (exact int64 sum), float for "float"
    (f32 sum), an int8/int16/int32/int64/uint8 tensor for "min" and "max"
    (in that dtype; an empty group gives its largest / smallest value, as
    the scatter reductions do), anything (None) for "count".
    num_groups <= 256.  Rows with mask false or a gid outside
    [0, num_groups) count nowhere.  Returns (states, group_count,
    arg_counts); arg_counts == group_count (callers with per-argument
    validity take the matmul or scatter path).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, once per 8 lanes (unique
    (kind, argument) pairs).
    """
    _check(gid, mask, args, num_groups)
    lanes, u_args, slot_of = _dedupe(args, kinds)
    if gid.shape[0] == 0:
        return _fan_out(*_zeros(lanes, num_groups, gid.device), slot_of)
    if gid.device.type == "cpu":
        count, u_states = _accumulate_plain(gid, mask, u_args, lanes,
                                            num_groups)
    elif gid.device.type == "cuda":
        count, u_states = _accumulate_cuda(gid, mask, u_args, lanes,
                                           num_groups)
    else:
        raise ValueError(f"group_aggregate: unsupported device {gid.device}")
    return _fan_out(count, u_states, slot_of)


group_aggregate.launches = 0
