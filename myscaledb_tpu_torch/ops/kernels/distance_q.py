"""K1: certified int8 (SQ8) per-segment lower bounds.

Port of myscaledb_tpu/ops/pallas/distance_q.py (``sq8_segmin_lower_bounds``,
``sidecar_pad_rows``, ``sq8_supported``).  The CUDA kernel is
``csrc/segmin_sq8.cu``; its note gives the bound derivation, the bound on
the H100 and the design.  ``segmin_sq8_plain`` is the same function in
plain PyTorch: the wrapper uses it only for tensors on the CPU, and
chip_smoke.py holds the kernel against it on the card.

The query-side quantization (scale, int8 query, residual norms, q_aux) is
``quantize_queries`` in the plain version; on the card the kernel's entry
point runs it as a prologue kernel, as the JAX package computes it in the
same jitted function as its ``pallas_call``.
"""

from __future__ import annotations

import torch

from myscaledb_tpu_torch.ops.kernels import build
from myscaledb_tpu_torch.ops.kernels.distance import (METRIC_CODES, inv_norm,
                                                      query_aux)

SEG = 128
TILE_N = 16384
NQ_MAX = 128
# The quantization scale is max|v| / 127.  XLA compiles that division by a
# constant into a product with the f32 reciprocal, so the JAX package's
# sidecars hold max|v| * f32(1/127); the same product here keeps sidecars
# bit-equal across the two packages.
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def sidecar_pad_rows(n: int) -> int:
    """Rows the sidecar is padded to (the JAX package's layout, so a
    sidecar built by either package fits the other)."""
    if n >= TILE_N:
        return -(-n // TILE_N) * TILE_N
    return -(-n // SEG) * SEG


def quantize_queries(q: torch.Tensor, metric: str):
    """Per-query symmetric int8 quantization.  Returns (q8 (nq, d) int8,
    qside (nq, 4) f32 = [scale, |q - scale q8|, |q| + |q - scale q8|,
    q_aux])."""
    q = q.float()
    sq = torch.clamp_min(q.abs().amax(dim=1) * INV_127, 1e-30)
    q8 = torch.clamp(torch.round(q / sq[:, None]), -127, 127).to(torch.int8)
    eq = q - q8.float() * sq[:, None]
    qe = torch.sqrt((eq * eq).sum(dim=1))
    qn = torch.sqrt((q * q).sum(dim=1))
    return q8, torch.stack([sq, qe, qn + qe, query_aux(q, metric)],
                           dim=1).contiguous()


def segmin_sq8_plain(x8, sides, q, maskvalid, metric: str):
    """Plain PyTorch version of the kernel.  The int8 product runs in f32
    (torch's int8 @ int8 returns int8 and wraps; |dot| <= 127^2 d < 2^24
    keeps f32 exact for d < 1040)."""
    n_pad = x8.shape[0]
    nq = q.shape[0]
    q8, qside = quantize_queries(q, metric)
    dot_i = q8.float() @ x8.float().T                       # (nq, n_pad)
    sqn_r, r, sc = sides[0][None, :], sides[1][None, :], sides[2][None, :]
    sq, qe, qne, qaux = (qside[:, i][:, None] for i in range(4))
    dot_mid = dot_i * (sc * sq)
    err = torch.sqrt(torch.clamp_min(sqn_r, 0.0)) * qe + r * qne
    err = err * 1.0001 + 1e-6
    if metric == "L2":
        lb = sqn_r - 2.0 * dot_mid + qaux - 2.0 * err
    elif metric == "Cosine":
        lb = 1.0 - (dot_mid + err) * inv_norm(sqn_r) * qaux
    else:
        lb = -(dot_mid + err)
    lb = torch.where(maskvalid.reshape(1, n_pad) != 0.0, lb, torch.inf)
    return lb.reshape(nq, n_pad // SEG, SEG).amin(dim=-1)


def _check(x8, sides, q, maskvalid, metric):
    if metric not in METRIC_CODES:
        raise ValueError(f"unknown metric {metric!r}")
    if x8.dim() != 2 or x8.dtype != torch.int8:
        raise TypeError(f"segmin_sq8: x8 must be (n_pad, d) int8, got "
                        f"{x8.dtype} {tuple(x8.shape)}")
    n_pad, d = x8.shape
    if n_pad % SEG != 0:
        raise ValueError(f"segmin_sq8: n_pad = {n_pad} is not a multiple "
                         f"of {SEG} (pad with sidecar_pad_rows)")
    if q.dim() != 2 or q.shape[1] != d or not 1 <= q.shape[0] <= NQ_MAX:
        raise ValueError(f"segmin_sq8: q must be (nq <= {NQ_MAX}, {d}), got "
                         f"{tuple(q.shape)}")
    for name, t, shape in (("sides", sides, (4, n_pad)), ("q", q, None),
                           ("maskvalid", maskvalid, (1, n_pad))):
        if t.dtype != torch.float32:
            raise TypeError(f"segmin_sq8: {name} must be float32, "
                            f"got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"segmin_sq8: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != x8.device:
            raise ValueError(f"segmin_sq8: {name} is on {t.device}, "
                             f"x8 on {x8.device}")


def segmin_sq8(x8, sides, q, maskvalid, metric: str):
    """Certified per-128-row-segment lower bounds on the true f32 scores.

    x8 (n_pad, d) int8, padded at build (sidecar_pad_rows); sides
    (4, n_pad) f32 = [|x|^2, |x - scale x8|, scale, valid]; q (nq, d) f32;
    maskvalid (1, n_pad) f32, the query predicate ANDed with validity (rows
    where it is 0 never surface).  Returns (nq, n_pad / 128) f32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check(x8, sides, q, maskvalid, metric)
    if x8.device.type == "cpu":
        return segmin_sq8_plain(x8, sides, q, maskvalid, metric)
    if x8.device.type != "cuda":
        raise ValueError(f"segmin_sq8: unsupported device {x8.device}")
    n_pad, d = x8.shape
    nq = q.shape[0]
    if d % 128 != 0:
        raise ValueError(f"segmin_sq8 kernel needs d % 128 == 0, got {d}")
    q = q.contiguous()
    if not (x8.is_contiguous() and sides.is_contiguous()
            and maskvalid.is_contiguous()):
        raise ValueError("segmin_sq8 kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (x8, sides, maskvalid)):
        raise ValueError("segmin_sq8 kernel needs x8, sides and maskvalid "
                         "aligned to 16 bytes")
    # the kernel's q8 (nq x d bytes), then its qside (nq x 4 f32)
    scratch = torch.empty(nq * d + nq * 16, dtype=torch.uint8,
                          device=x8.device)
    out = torch.empty((nq, n_pad // SEG), dtype=torch.float32,
                      device=x8.device)
    lib = build.library()
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msdb_segmin_sq8(
            x8.data_ptr(), sides.data_ptr(), q.data_ptr(), scratch.data_ptr(),
            maskvalid.data_ptr(), out.data_ptr(), n_pad, d, nq,
            METRIC_CODES[metric], stream)
    build.check(rc, "segmin_sq8")
    segmin_sq8.launches += 1
    return out


segmin_sq8.launches = 0


def sq8_supported(d: int, nq: int = 1) -> bool:
    """Shape conditions under which the scan takes the certified int8 path
    (the JAX package's, minus its TPU-backend check)."""
    return d % 128 == 0 and nq <= NQ_MAX
