"""Grouped sums/counts as factorized one-hot matrix products: the port of
myscaledb_tpu/ops/aggregate_matmul.py (``matmul_group_aggregate``).

This is the path for G > 256 and for arguments with their own validity
(``sumIf``, ``count(x)`` over a Nullable x).  The JAX package leaves it to
XLA's matrix products and has no kernel here, so the port uses
``torch.matmul``.  Factorize the group id g = hi * 128 + lo, build the
128-wide one-hot of lo, and per block of rows contract

    out[f, hi, lo] = sum_rows feats[r, f] * [hi(r) == hi] * oh_lo[r, lo]

as one (F, B) @ (B, 128) product per hi bucket.

Exact integer sums: int values are offset to uint32 and split into six
base-64 limbs; with 2^18-row blocks each f32 partial is integer-exact
(B * 63 < 2^24), block partials accumulate in int64, and the final sum is
sum_j 64^j * limb_j - 2^31 * count.  Float sums accumulate f32 partials.

The products must run in full f32.  TF32 keeps 10 mantissa bits, so a
float argument's values would be rounded before they are summed.  PyTorch
runs f32 products on the card in full f32 unless a caller turned TF32 on;
this path then refuses to run rather than change the caller's global
setting.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 18          # rows per matmul block: 2^18 * 63 < 2^24 (exactness)
N_LIMBS = 6              # base-64 limbs covering uint32
LO = 128                 # factor of the group id


def _check_full_f32(device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "matmul_group_aggregate needs full-f32 matrix products, but "
            "torch.backends.cuda.matmul.allow_tf32 is True; set it False "
            "(or torch.set_float32_matmul_precision('highest'))")


def matmul_group_aggregate(gid, mask, args, kinds: tuple, num_groups: int,
                           arg_valids=None):
    """Grouped sums/counts via one-hot matmuls.

    kinds: per-arg "int" (exact int64 sum) | "float" (f32 sum) | "count".
    A count argument is never read (None is fine).  Returns (states,
    group_count, arg_counts): states[i] is int64 (G,) for int/count, f32
    (G,) for float; group_count int64 (G,) counts mask-selected rows;
    arg_counts[i] counts the rows where argument i is also valid.
    """
    n = gid.shape[0]
    dev = gid.device
    _check_full_f32(dev)
    if n == 0:
        zi = torch.zeros(num_groups, dtype=torch.int64, device=dev)
        zf = torch.zeros(num_groups, dtype=torch.float32, device=dev)
        states = tuple(zf if k == "float" else zi for k in kinds)
        return states, zi, tuple(zi for _ in kinds)
    G_pad = -(-num_groups // LO) * LO
    nhi = G_pad // LO
    block = 128
    while block < min(n, BLOCK):
        block *= 2
    n_pad = -(-n // block) * block
    pad = n_pad - n

    def padded(t, fill):
        t = torch.as_tensor(t, device=dev)
        if pad:
            t = torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                         device=dev)])
        return t

    gid = padded(gid.to(torch.int32), 0)
    mask = padded(mask.to(torch.bool), False)
    args = tuple(padded(a, 0) if k != "count" else None
                 for a, k in zip(args, kinds))
    valids = tuple(padded(v.to(torch.bool), False) if v is not None else None
                   for v in (arg_valids or (None,) * len(kinds)))
    nb = n_pad // block

    # feature layout: [global_count] + per-arg features
    # int arg  -> 6 limb rows + 1 count row
    # float arg-> 1 value row + 1 count row
    # count    -> 1 count row
    rows_of = {"int": N_LIMBS + 1, "float": 2, "count": 1}
    F = 1 + sum(rows_of[k] for k in kinds)
    float_row = torch.zeros((F, 1), dtype=torch.bool, device=dev)
    row = 1
    for k in kinds:
        if k == "float":
            float_row[row] = True
        row += rows_of[k]
    lo_iota = torch.arange(LO, dtype=torch.int32, device=dev)

    def block_features(s, e):
        m = mask[s:e]
        cols = [m.to(torch.float32)]                    # global count row
        for i, k in enumerate(kinds):
            am = m if valids[i] is None else m & valids[i][s:e]
            amf = am.to(torch.float32)
            if k == "int":
                u = args[i][s:e].to(torch.int64) + 2 ** 31   # as uint32
                for j in range(N_LIMBS):
                    limb = ((u >> (6 * j)) & 63).to(torch.float32)
                    cols.append(limb * amf)
                cols.append(amf)                         # per-arg count
            elif k == "float":
                cols.append(args[i][s:e].to(torch.float32) * amf)
                cols.append(amf)
            else:
                cols.append(amf)
        return torch.stack(cols, dim=1)                  # (block, F)

    acc_i = torch.zeros((F, G_pad), dtype=torch.int64, device=dev)
    acc_f = torch.zeros((F, G_pad), dtype=torch.float32, device=dev)
    for bi in range(nb):
        s, e = bi * block, (bi + 1) * block
        feats = block_features(s, e)
        g = gid[s:e]
        oh_lo = ((g & (LO - 1))[:, None] == lo_iota).to(torch.float32)
        hi = g >> 7
        parts = []
        for h in range(nhi):
            sel = (hi == h).to(torch.float32)
            lhs = feats * sel[:, None]                   # (block, F)
            parts.append(lhs.T @ oh_lo)                  # (F, LO)
        part = torch.cat(parts, dim=-1)                  # (F, nhi * LO)
        exact = torch.where(float_row, 0.0, part)
        acc_i += torch.round(exact).to(torch.int64)
        acc_f += part

    group_count = acc_i[0, :num_groups]
    states, arg_counts = [], []
    row = 1
    for k in kinds:
        if k == "int":
            total = torch.zeros(num_groups, dtype=torch.int64, device=dev)
            for j in range(N_LIMBS):
                total = total + (acc_i[row + j, :num_groups] << (6 * j))
            cnt = acc_i[row + N_LIMBS, :num_groups]
            states.append(total - (cnt << 31))
            arg_counts.append(cnt)
        elif k == "float":
            states.append(acc_f[row, :num_groups])
            arg_counts.append(acc_i[row + 1, :num_groups])
        else:
            states.append(acc_i[row, :num_groups])
            arg_counts.append(acc_i[row, :num_groups])
        row += rows_of[k]
    return tuple(states), group_count, tuple(arg_counts)
