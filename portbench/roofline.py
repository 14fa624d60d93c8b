"""The card's peaks and the bytes each kernel's inputs need.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense rates, at
its full 700 W power limit; a share is stated against them with the card's
power limit printed beside it.  Bytes count each input byte read once and
each output byte written once, whatever a kernel reads again, from the
shapes alone."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "fp32_flops": 67e12,
         "tf32_flops": 495e12, "int8_ops": 1979e12}
SEG = 128          # rows a segment minimum covers (K1, K2)


def k1_bytes(n: int, d: int, nq: int) -> int:
    """K1 (certified int8 segment lower bounds) for ``nq`` queries over
    ``n`` rows of width ``d``: the int8 codes, three f32 side values a row
    (squared norm, residual norm, scale) and the f32 row mask, the f32
    queries in, one f32 bound a query and 128-row segment out."""
    nseg = -(-n // SEG)
    return n * d + n * 3 * 4 + n * 4 + nq * d * 4 + nq * nseg * 4


def k2_bytes(n: int, d: int, nq: int) -> int:
    """K2 (f32 segment minima): the f32 rows, their squared norms and the
    f32 row mask, the queries in, one f32 minimum a query and segment
    out."""
    nseg = -(-n // SEG)
    return n * d * 4 + n * 4 + n * 4 + nq * d * 4 + nq * nseg * 4


def bound_s(nbytes: float) -> float:
    """The least time the bytes need at the card's HBM rate."""
    return nbytes / HBM_BYTES_PER_S
