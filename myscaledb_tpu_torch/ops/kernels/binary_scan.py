"""K5: the binary-vector segment minimum (pass 1 of the exact binary top-k).

Port of myscaledb_tpu/ops/pallas/binary_scan.py (``binary_segment_mins``,
``SEG``, ``SEGS_PER_STEP``).  Per 1024-row segment and per query it gives
the minimum Hamming distance popcount(x ^ q), or for Jaccard
(union - inter) / union in f32 (1 when the union is empty); rows >= n and
masked rows give +inf.  The layout is the JAX package's segment-major
(nseg, words, SEG): each segment is a contiguous row range, which the
rescore's exactness proof needs (ops/binary_vector.py), and its rows are
contiguous per word, so loads coalesce on the card.

torch has few operations on uint32, so packed words travel as int32
tensors holding the same bits.  torch has no popcount either:
``popcount32`` is a SWAR count in int64 lanes.

The CUDA kernel is ``csrc/binary_scan.cu``; its note gives the bound on the
H100 and the design.  ``binary_segment_mins_plain`` is the same function in
plain PyTorch: the wrapper uses it only for tensors on the CPU, and
chip_smoke.py holds the kernel against it on the card.  Integer scores, a
float minimum and an IEEE division are exact in any order, so the two are
bit-equal.
"""

from __future__ import annotations

import torch

from myscaledb_tpu_torch.ops.kernels import build

SEG = 1024                 # rows per segment
SEGS_PER_STEP = 16         # the JAX grid step; the tables pad to it
QCHUNK_WORDS = 8192        # query words staged in shared memory (32 KB)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word of an int32/int64 tensor (the low 32
    bits), as int32."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def word_scores(x: torch.Tensor, q: torch.Tensor, metric: str,
                dim: int) -> torch.Tensor:
    """f32 scores of packed rows x against the broadcast query words q,
    summing popcounts over axis ``dim`` (the words): Hamming as the integer
    count, Jaccard as (union - inter) / union, 1 for an empty union."""
    if metric == "Hamming":
        return popcount32(x ^ q).sum(dim, dtype=torch.int32) \
            .to(torch.float32)
    inter = popcount32(x & q).sum(dim, dtype=torch.int32).to(torch.float32)
    union = popcount32(x | q).sum(dim, dtype=torch.int32).to(torch.float32)
    return torch.where(union > 0, (union - inter) / union,
                       torch.ones((), dtype=torch.float32, device=x.device))


def _check(x3, qw, mask2, metric, has_mask):
    if metric not in ("Hamming", "Jaccard"):
        raise ValueError(f"binary_segment_mins: unknown metric {metric!r}")
    if x3.dim() != 3 or x3.shape[2] != SEG:
        raise ValueError(f"binary_segment_mins: x3 must be (nseg, words, "
                         f"{SEG}), got {tuple(x3.shape)}")
    nseg, words, _ = x3.shape
    if qw.dim() != 2 or qw.shape[1] != words:
        raise ValueError(f"binary_segment_mins: qw must be (nq, {words}), "
                         f"got {tuple(qw.shape)}")
    for name, t in (("x3", x3), ("qw", qw)):
        if t.dtype != torch.int32:
            raise ValueError(f"binary_segment_mins: {name} must hold packed "
                             f"words as int32, got {t.dtype}")
    if has_mask and tuple(mask2.shape) != (nseg, SEG):
        raise ValueError(f"binary_segment_mins: mask2 must be ({nseg}, "
                         f"{SEG}), got {tuple(mask2.shape)}")
    for name, t in (("qw", qw), ("mask2", mask2)):
        if t.device != x3.device:
            raise ValueError(f"binary_segment_mins: {name} is on {t.device}, "
                             f"x3 on {x3.device}")


def binary_segment_mins_plain(x3, qw, mask2, metric: str, n: int,
                              has_mask: bool) -> torch.Tensor:
    """Plain PyTorch version of ``binary_segment_mins``."""
    _check(x3, qw, mask2, metric, has_mask)
    nseg, words, _ = x3.shape
    row = torch.arange(nseg * SEG, device=x3.device).view(nseg, SEG)
    live = row < n
    if has_mask:
        live &= mask2 != 0
    inf = torch.full((), float("inf"), device=x3.device)
    mins = [torch.where(live, word_scores(x3, q.view(1, words, 1), metric,
                                          dim=1), inf).amin(dim=1)
            for q in qw]
    if not mins:
        return torch.zeros((nseg, 0), device=x3.device)
    return torch.stack(mins, dim=1)


def binary_segment_mins(x3, qw, mask2, metric: str, n: int,
                        has_mask: bool) -> torch.Tensor:
    """x3: (nseg, words, SEG) int32 segment-major packed table; qw: (nq,
    words) int32 packed queries; mask2: (nseg, SEG) uint8 row validity
    (only read when has_mask).  Returns (nseg, nq) f32 per-segment score
    minima (+inf for fully masked or padded segments).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check(x3, qw, mask2, metric, has_mask)
    if x3.device.type == "cpu":
        return binary_segment_mins_plain(x3, qw, mask2, metric, n, has_mask)
    if x3.device.type != "cuda":
        raise ValueError(f"binary_segment_mins: unsupported device "
                         f"{x3.device}")
    nseg, words, _ = x3.shape
    nq = qw.shape[0]
    out = torch.empty((nseg, nq), dtype=torch.float32, device=x3.device)
    if nseg == 0 or nq == 0:
        return out
    if nseg >= 2 ** 31 or words > QCHUNK_WORDS:
        raise ValueError(f"binary_segment_mins kernel takes nseg < 2^31 and "
                         f"words <= {QCHUNK_WORDS} (one query in 32 KB of "
                         f"shared memory), got {nseg}, {words}")
    x3 = x3.contiguous()
    qw = qw.contiguous()
    mask2 = mask2.to(torch.uint8).contiguous() if has_mask else x3
    qchunk = max(1, min(nq, QCHUNK_WORDS // words))
    with torch.cuda.device(x3.device):
        rc = build.library().msdb_binary_segmin(
            x3.data_ptr(), qw.data_ptr(), mask2.data_ptr(), out.data_ptr(),
            nseg, words, nq, n, int(has_mask), int(metric == "Jaccard"),
            qchunk, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "binary_segment_mins")
    binary_segment_mins.launches += 1
    return out


binary_segment_mins.launches = 0
