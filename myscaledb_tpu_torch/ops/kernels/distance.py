"""K2: f32 per-segment minimum of the selection scores.

Port of myscaledb_tpu/ops/pallas/distance.py (``fused_segmin_scores``,
``pallas_supported``).  The CUDA kernel is ``csrc/segmin_f32.cu``; its note
gives the bound on the H100 and the design: the products run on the
tensor cores as three TF32 products per term.  ``segmin_f32_plain`` is the
same function in plain PyTorch with the full f32 product: the wrapper uses
it only for tensors on the CPU, and chip_smoke.py holds the kernel against
it on the card.  ``segmin_f32_3xtf32`` repeats the kernel's split
(``tf32_round``) and its 32-dim chunks for the tests, but not the tensor
cores' accumulation inside a chunk, which only the card tests check.

Unlike the TPU kernel, which pads its output to whole 8192-row tiles, this
one returns exactly ceil(n / 128) segments per query.
"""

from __future__ import annotations

import torch

from myscaledb_tpu_torch.ops.kernels import build

SEG = 128
NQ_MAX = 128
CHUNK = 32               # dims the kernel sums in fresh registers
METRIC_CODES = {"L2": 0, "Cosine": 1, "IP": 2}


def query_aux(q, metric: str):
    """The per-query term of the selection scores (``q_aux``): |q|^2 for
    L2, 1/|q| for Cosine (0 for a zero query), zeros for IP."""
    if metric == "Cosine":
        qn = torch.sqrt((q * q).sum(dim=1))
        return torch.where(qn > 0.0, 1.0 / qn, torch.zeros_like(qn))
    if metric == "L2":
        return (q * q).sum(dim=1)
    return torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)


def inv_norm(sqn):
    """1/|x| from squared norms, 0 where the norm is 0.  A correctly
    rounded 1/sqrt, as the kernels compute it (not an approximate
    rsqrt)."""
    root = torch.sqrt(torch.clamp_min(sqn, 1e-30))
    return torch.where(sqn > 0.0, 1.0 / root,
                       torch.zeros((), dtype=sqn.dtype, device=sqn.device))


def segmin_scores(dot, sqn, q_aux, metric: str):
    """Selection scores from the dot products (nq, n), with the formulas
    and the evaluation order of the TPU kernel.  Every stage-1 path of the
    scan scores through this one function."""
    if metric == "L2":
        return sqn[None, :] - 2.0 * dot + q_aux[:, None]
    if metric == "Cosine":
        return 1.0 - dot * inv_norm(sqn)[None, :] * q_aux[:, None]
    return -dot


def _segment_mins(dot, sqn, q_aux, mask, metric: str):
    """Scores from the (nq, n) dot products, +inf for masked rows, minimum
    over each 128-row segment."""
    nq, n = dot.shape
    s = segmin_scores(dot, sqn, q_aux, metric)
    if mask is not None:
        s = torch.where(mask[None, :] != 0.0, s, torch.inf)
    nseg = -(-n // SEG)
    if nseg * SEG != n:
        s = torch.cat([s, torch.full((nq, nseg * SEG - n), torch.inf,
                                     dtype=s.dtype, device=s.device)], dim=1)
    return s.reshape(nq, nseg, SEG).amin(dim=-1)


def segmin_f32_plain(x, q, sqn, q_aux, mask, metric: str):
    """Plain PyTorch version of the kernel: full f32 product, scores,
    +inf for masked rows, minimum over each 128-row segment."""
    return _segment_mins(q @ x.T, sqn, q_aux, mask, metric)


def tf32_round(a):
    """``cvt.rna.tf32.f32`` on f32 values: round to the 10 mantissa bits of
    TF32, ties away from zero, on the bits (finite inputs)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def segmin_f32_3xtf32(x, q, sqn, q_aux, mask, metric: str):
    """The kernel's split and chunking in plain PyTorch: each value split
    into hi = tf32(a) and lo = tf32(a - hi), each 32-dim chunk's product
    summed on its own as lo.hi + hi.lo + hi.hi (the lo.lo term dropped),
    and the chunks' sums added in order in f32.  The sums inside a chunk
    are f32 matmuls here, not the tensor cores' truncating accumulation,
    so only the card tests (tests/test_torch_cuda.py) hold that part.  For
    the tests; the wrapper does not use it."""
    x_hi, q_hi = tf32_round(x), tf32_round(q)
    x_lo, q_lo = tf32_round(x - x_hi), tf32_round(q - q_hi)
    dot = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32,
                      device=x.device)
    for k in range(0, x.shape[1], CHUNK):
        c = slice(k, k + CHUNK)
        dot = dot + (q_hi[:, c] @ x_lo[:, c].T + q_lo[:, c] @ x_hi[:, c].T
                     + q_hi[:, c] @ x_hi[:, c].T)
    return _segment_mins(dot, sqn, q_aux, mask, metric)


def _check(x, q, sqn, q_aux, mask, metric):
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    if x.dim() != 2 or q.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"segmin_f32: x {tuple(x.shape)} and q "
                         f"{tuple(q.shape)} must be (n, d) and (nq, d)")
    n, nq = x.shape[0], q.shape[0]
    if not 1 <= nq <= NQ_MAX:
        raise ValueError(f"segmin_f32: nq = {nq}, must be in [1, {NQ_MAX}]")
    want = [("x", x, (n, x.shape[1])), ("q", q, (nq, x.shape[1])),
            ("sqn", sqn, (n,)), ("q_aux", q_aux, (nq,))]
    if mask is not None:
        want.append(("mask", mask, (n,)))
    for name, t, shape in want:
        if t.dtype != torch.float32:
            raise TypeError(f"segmin_f32: {name} must be float32, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"segmin_f32: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"segmin_f32: {name} is on {t.device}, "
                             f"x on {x.device}")


def segmin_f32(x, q, sqn, q_aux, mask, metric: str):
    """Per-query, per-128-row-segment minima of the selection scores.

    x (n, d) f32, never padded; q (nq, d) f32 with nq <= 128; sqn (n,) f32
    squared row norms; q_aux (nq,) f32 (|q|^2 for L2, 1/|q| for Cosine,
    unused for IP); mask None or (n,) f32 (nonzero = selected).  Returns
    (nq, ceil(n / 128)) f32; masked rows and rows past n count as +inf.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check(x, q, sqn, q_aux, mask, metric)
    if x.device.type == "cpu":
        return segmin_f32_plain(x, q, sqn, q_aux, mask, metric)
    if x.device.type != "cuda":
        raise ValueError(f"segmin_f32: unsupported device {x.device}")
    n, d = x.shape
    nq = q.shape[0]
    if d % 32 != 0:
        raise ValueError(f"segmin_f32 kernel needs d % 32 == 0, got d = {d}")
    tensors = [x, q, sqn, q_aux] + ([mask] if mask is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segmin_f32 kernel needs contiguous tensors")
    if x.data_ptr() % 16 != 0:
        raise ValueError("segmin_f32 kernel needs x aligned to 16 bytes")
    out = torch.empty((nq, -(-n // SEG)), dtype=torch.float32,
                      device=x.device)
    # scratch: the queries' TF32 hi and lo halves
    qsplit = torch.empty((2, nq, d), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msdb_segmin_f32(
            x.data_ptr(), q.data_ptr(), sqn.data_ptr(), q_aux.data_ptr(),
            mask.data_ptr() if mask is not None else None, qsplit.data_ptr(),
            out.data_ptr(), n, d, nq, METRIC_CODES[metric], stream)
    build.check(rc, "segmin_f32")
    segmin_f32.launches += 1
    return out


segmin_f32.launches = 0


def pallas_supported(d: int, nq: int = 1) -> bool:
    """Shape conditions under which the scan takes the segment-min path
    (the JAX package's, minus its TPU-backend check: CUDA tensors launch
    the kernel, CPU tensors take the plain version)."""
    return d % 128 == 0 and nq <= NQ_MAX
