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

The CUDA kernel is ``csrc/merge_count.cu``; its note gives the bound on
the H100 and the design.  ``merge_count_plain`` is the same function in
plain PyTorch (``torch.searchsorted``, a compare and a sum): the wrapper
uses it only for tensors on the CPU, and chip_smoke.py holds the kernel
against it on the card.  Counts are integers, so the two are equal.
"""

from __future__ import annotations

import torch

from myscaledb_tpu_torch.ops.kernels import build

IMAX = 2 ** 31 - 1
BLOCKS_PER_SM = 16           # grid of the kernel: a few waves of 256 threads


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


def merge_count_plain(build_sorted, probe_keys, build_has_max) -> torch.Tensor:
    """Plain PyTorch version of ``merge_count``."""
    probe = torch.as_tensor(probe_keys).to(torch.int32)
    has_max = _has_max(build_has_max, probe.device)
    _check(build_sorted, probe, has_max)
    nb = build_sorted.shape[0]
    n_max = (probe == IMAX).sum(dtype=torch.int64)
    extra = torch.where(has_max, n_max, torch.zeros_like(n_max))
    if nb == 0:
        return extra
    pos = torch.searchsorted(build_sorted, probe)
    hit = (pos < nb) & (build_sorted[pos.clamp(max=nb - 1)] == probe) \
        & (probe != IMAX)
    return hit.sum(dtype=torch.int64) + extra


def merge_count(build_sorted, probe_keys, build_has_max) -> torch.Tensor:
    """Count the probe keys present in the sorted build keys (ANY
    semantics).

    build_sorted: (nb,) int32 ascending, invalid rows = INT32_MAX (from
    ``prepare_build``).  probe_keys: (n,) integer keys of at most 32 bits.
    build_has_max: a genuine valid INT32_MAX build key exists (0-d bool
    tensor or Python bool).  Returns a 0-d int64 tensor.  CPU tensors take
    the plain version; CUDA tensors launch the kernel, with no host
    synchronisation.
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
    out = torch.zeros((), dtype=torch.int64, device=probe.device)
    if n == 0:
        return out
    with torch.cuda.device(probe.device):
        sms = torch.cuda.get_device_properties(probe.device) \
            .multi_processor_count
        blocks = min(-(-n // 256), sms * BLOCKS_PER_SM)
        rc = build.library().msdb_merge_count(
            build_sorted.data_ptr(), nb, probe.data_ptr(), n,
            has_max.data_ptr(), out.data_ptr(), blocks,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "merge_count")
    merge_count.launches += 1
    return out


merge_count.launches = 0
