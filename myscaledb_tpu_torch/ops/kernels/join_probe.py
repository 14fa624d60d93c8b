"""K7: each probe row's build row through the dense direct-lookup table
of a join on one integer key (``ops/join.py::probe_sorted``).

It replaces no TPU kernel: the JAX package probes its dense join table
with ``jnp`` operations, and so did the port, as a chain of ten
element-wise passes over the probe rows (``probe_direct_plain``, kept
here unchanged).  The CUDA kernel (``csrc/join_probe.cu``) makes one
pass: it reads each key, looks its row up in the table (which stays in
L2) and writes the row and the found flag; its note gives the bound on
the H100 and the design.  ``probe_direct_plain`` is the wrapper's route
for tensors on the CPU, and the card tests hold the kernel against it.
Both give equal outputs: rows and flags are integers.
"""

from __future__ import annotations

import torch

from myscaledb_tpu_torch.ops.hashtable import INT32_MAX
from myscaledb_tpu_torch.ops.kernels import build

KEY_DTYPES = (torch.int32, torch.int64)


def _check(key, lookup, lo, mask):
    if not isinstance(lo, int):
        raise ValueError(f"probe_direct: lo must be an int, got "
                         f"{type(lo).__name__}")
    if key.dim() != 1 or key.dtype not in KEY_DTYPES:
        raise ValueError(f"probe_direct: key must be a 1-D int32 or int64 "
                         f"tensor, got {key.dtype} of shape "
                         f"{tuple(key.shape)}")
    if lookup.dim() != 1 or lookup.dtype != torch.int32 \
            or lookup.shape[0] == 0:
        raise ValueError(f"probe_direct: lookup must be a non-empty 1-D "
                         f"int32 tensor, got {lookup.dtype} of shape "
                         f"{tuple(lookup.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != tuple(key.shape)):
        raise ValueError(f"probe_direct: mask must be a bool tensor of "
                         f"shape {tuple(key.shape)}, got {mask.dtype} of "
                         f"shape {tuple(mask.shape)}")
    for name, t in (("key", key), ("lookup", lookup), ("mask", mask)):
        if t is None:
            continue
        if t.device != key.device:
            raise ValueError(f"probe_direct: {name} is on {t.device}, key "
                             f"on {key.device}")
        if not t.is_contiguous():
            raise ValueError(f"probe_direct: {name} is not contiguous")


def probe_direct_plain(key, lookup, lo: int, mask=None):
    """Plain PyTorch version of ``probe_direct``: the element-wise chain
    that ``probe_sorted`` ran before K7."""
    _check(key, lookup, lo, mask)
    m = lookup.shape[0]
    idx = key.to(torch.int64) - lo
    hit = (idx >= 0) & (idx < m)
    row = lookup[idx.clamp_(0, m - 1)]
    del idx                     # 8 B a probe row, gone before the next
    found = hit & (row != INT32_MAX)
    if mask is not None:
        found = found & mask
    return torch.where(found, row, INT32_MAX), found


def probe_direct(key, lookup, lo: int, mask=None):
    """Each probe row's build row through a direct lookup.

    key (n,) int32 or int64, contiguous; lookup (m,) int32, the build row
    of key ``lo + j`` at j (INT32_MAX where no build row has it); mask
    (n,) bool or None: rows it drops find nothing.  Returns (row (n,)
    int32, INT32_MAX where not found; found (n,) bool) on the key's
    device.  CPU tensors take the plain version; CUDA tensors launch the
    kernel, once a call with rows (none for an empty probe), and raise
    where it cannot run.
    """
    _check(key, lookup, lo, mask)
    if key.device.type == "cpu":
        return probe_direct_plain(key, lookup, lo, mask)
    if key.device.type != "cuda":
        raise ValueError(f"probe_direct: unsupported device {key.device}")
    n = key.shape[0]
    row = torch.empty(n, dtype=torch.int32, device=key.device)
    found = torch.empty(n, dtype=torch.bool, device=key.device)
    if n == 0:
        return row, found
    with torch.cuda.device(key.device):
        rc = build.library().msdb_join_probe_direct(
            key.data_ptr(), key.element_size(), lookup.data_ptr(), lo,
            lookup.shape[0], None if mask is None else mask.data_ptr(), n,
            row.data_ptr(), found.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "join_probe")
    probe_direct.launches += 1
    return row, found


probe_direct.launches = 0
