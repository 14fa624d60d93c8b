"""The engine's "Cluster": a mesh of shards and the collectives that merge
their results.  The port of myscaledb_tpu/parallel/mesh.py.

The JAX package is single-controller: one Session owns every table, a
``jax.sharding.Mesh`` runs one shard body per device under ``shard_map``,
and XLA collectives (``all_gather``, ``psum``, ``all_to_all``,
``ppermute``) merge the bodies' results.  The port keeps that model with
logical shards: a table column keeps its global (padded) view, a shard
body runs on its shard's row slice (``row_slices``), and each collective
here is a function over one tensor per shard, shard p's tensor on
``mesh.device(p)``.

Every shard of a mesh sits on one device: with all shards on one device
the collectives are stacks, reductions and index shuffles on that device,
with no host round trip.  ``make_mesh(n)`` puts n logical shards on one
device (the counterpart of the JAX tests' 8 virtual CPU devices, and the
only mesh a one-card machine can hold); a mesh over two or more distinct
devices raises ``NotPortedError``.  The shard bodies call only the
collectives of this module, so a mesh over several cards changes this
file and the table storage, not the operators.

Collectives return a replicated value as one tensor (every shard shares
the device) and a row-sharded value as a list of per-shard tensors.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional, Sequence

import torch

from myscaledb_tpu_torch.errors import NotPortedError

SHARD_AXIS = "shard"


class Mesh:
    """A fixed number of shards, one device per shard.  ``shape`` maps the
    axis name to the shard count, as a JAX mesh's does."""

    def __init__(self, devices: Sequence, axis: str = SHARD_AXIS):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        if len({str(d) for d in devs}) > 1:
            raise NotPortedError("a multi-device mesh (shards on two or "
                                 "more devices)", "multi-card mesh")
        self.devices = devs
        self.axis = axis

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def device(self, p: int = 0) -> torch.device:
        return self.devices[p]

    def __repr__(self) -> str:
        return f"Mesh({self.size} shards on {self.devices[0]})"


def shard_axis() -> str:
    return SHARD_AXIS


def _visible_devices(device) -> list:
    if device is not None:
        return [torch.device(device)]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    from myscaledb_tpu_torch.errors import NoDeviceError
    raise NoDeviceError("make_mesh(): no CUDA device is available; pass "
                        "device=\"cpu\" for a mesh on the CPU")


def make_mesh(n_shards: Optional[int] = None, axis: str = SHARD_AXIS,
              device=None) -> Mesh:
    """A mesh of ``n_shards`` shards.  Without a count: one shard per
    visible device, as the JAX package's ``make_mesh`` (the CUDA cards, or
    ``device`` alone when given).  With a count: that many logical shards
    on one device (``device``, else the first card)."""
    devs = _visible_devices(device)
    if n_shards is None:
        return Mesh(devs, axis)
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return Mesh([devs[0]] * int(n_shards), axis)


def shard_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` placed for a row split across the mesh: on the mesh's device,
    its row count a multiple of the shard count (the storage layer pads
    tables to one).  The global view is kept; ``row_slices`` gives each
    shard its rows."""
    t = torch.as_tensor(t).to(mesh.device(0))
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{mesh.size} shards")
    return t


def row_slices(mesh: Mesh, t) -> list:
    """Shard p's view of rows [p * n_loc, (p + 1) * n_loc) for every p (no
    copy); None stays None for every shard."""
    nsh = mesh.size
    if t is None:
        return [None] * nsh
    n = t.shape[0]
    if n % nsh:
        raise ValueError(f"{n} rows do not split over {nsh} shards")
    n_loc = n // nsh
    return [t[p * n_loc:(p + 1) * n_loc] for p in range(nsh)]


# -- collectives: one tensor per shard in, in shard order -------------------

def all_gather(xs: Sequence[torch.Tensor], tiled: bool = False
               ) -> torch.Tensor:
    """Every shard's tensor, replicated: stacked on a new leading axis
    (nsh, ...), or concatenated along axis 0 when ``tiled``."""
    return torch.cat(list(xs)) if tiled else torch.stack(list(xs))


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over the shards, added in shard order."""
    return reduce(torch.add, xs)


def pmin(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return reduce(torch.minimum, xs)


def pmax(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return reduce(torch.maximum, xs)


def all_to_all(xs: Sequence[torch.Tensor]) -> list:
    """Tiled all-to-all along axis 0: shard q's tensor is nsh blocks of
    equal rows, block p bound for shard p; shard p receives the blocks
    bound for it, from shard 0 first."""
    nsh = len(xs)
    x = torch.stack(list(xs))                       # (src, nsh * cap, ...)
    cap = x.shape[1] // nsh
    x = x.reshape((nsh, nsh, cap) + tuple(x.shape[2:]))
    x = x.transpose(0, 1).contiguous()              # (dst, src, cap, ...)
    return [x[p].reshape((nsh * cap,) + tuple(x.shape[3:]))
            for p in range(nsh)]


def ppermute(xs: Sequence[torch.Tensor], perm) -> list:
    """Shard ``dst`` receives shard ``src``'s tensor for each (src, dst) of
    ``perm``; a shard that is no destination receives zeros."""
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src]
    return out
