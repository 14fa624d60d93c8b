"""The engine's "Cluster": a mesh of shards and the collectives that merge
their results.  The port of myscaledb_tpu/parallel/mesh.py.

The JAX package is single-controller: one Session owns every table, a
``jax.sharding.Mesh`` runs one shard body per device under ``shard_map``,
and XLA collectives (``all_gather``, ``psum``, ``all_to_all``,
``ppermute``) merge the bodies' results.  The port keeps that model in
one process: shard p has a device, ``mesh.device(p)``; its rows are a
tensor of their own there (a ``RowSplit`` holds one tensor per shard); a
shard body computes on its shard's tensors on its shard's card; and each
collective here takes one tensor per shard and moves what it merges with
peer copies (``tensor.to(device)``, over NVLink where the cards have it),
not ``torch.distributed``, which would need one process a card.

``make_mesh()`` is one shard per visible card, as the JAX package's;
``make_mesh(n)`` puts shard p on card ``p % device_count`` (on a one-card
machine n logical shards share the card); ``make_mesh(n, device=d)`` keeps
every shard on ``d`` (the JAX tests' 8 virtual CPU devices are the CPU
here).  The storage layout is the same whether two shards share a card or
not, so the one-card mesh runs the code a multi-card one runs; only the
copies between distinct cards are then copies within one.

Where values live: a row-split value is a ``RowSplit`` (shard p's part on
``mesh.device(p)``); a replicated value (a query vector, a merged top-k,
merged group states, a psum) is one tensor on ``mesh.device(0)``, and a
shard body that reads it moves it to its own card first: no shard body
computes on another card's tensor.

Streams: a shard body queues its work on its card's current stream, and
the host waits for none of it.  A peer copy (``tensor.to(device)``) is
ordered on the current streams of both cards it joins.  The fused config-5
step (``parallel/pipeline.py``) runs its join branch on a second stream of
each card, ``Mesh.side_streams()``, made current on every card at once so
that the branch's copies stay off the streams the scans run on.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional, Sequence

import numpy as np
import torch

SHARD_AXIS = "shard"


class Mesh:
    """A fixed number of shards, one device per shard (two shards may
    share one).  ``shape`` maps the axis name to the shard count, as a JAX
    mesh's does.  A CUDA device past the visible cards raises."""

    def __init__(self, devices: Sequence, axis: str = SHARD_AXIS):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        for d in devs:
            if d.type == "cuda":
                n_cards = torch.cuda.device_count() \
                    if torch.cuda.is_available() else 0
                if d.index is not None and d.index >= n_cards:
                    raise ValueError(f"no device {d}: {n_cards} CUDA "
                                     "card(s) visible")
        # a card without an index is the current one: pinned here, so
        # that shards name their card and comparisons by device hold
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if d.type == "cuda" and d.index is None else d
                        for d in devs]
        self.axis = axis
        self._side = None

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def device(self, p: int = 0) -> torch.device:
        return self.devices[p]

    def side_streams(self) -> dict:
        """One side stream per distinct CUDA card of the mesh, keyed by the
        card: made at the first call and kept with the mesh, so that the
        shards on one card share it from step to step.  Empty for a CPU
        mesh, whose tensors have no streams (no CUDA call is made); on a
        CUDA mesh a stream that cannot be made raises."""
        if self._side is None:
            self._side = {d: torch.cuda.Stream(device=d)
                          for d in dict.fromkeys(self.devices)
                          if d.type == "cuda"}
        return self._side

    @property
    def n_cards(self) -> int:
        """Distinct devices the shards sit on."""
        return len({str(d) for d in self.devices})

    def __repr__(self) -> str:
        return f"Mesh({self.size} shards on {self.n_cards} device(s))"


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
    visible card, as the JAX package's ``make_mesh`` (``device`` alone when
    given).  With a count: shard p on card ``p % device_count``, or every
    shard on ``device`` when given."""
    devs = _visible_devices(device)
    if n_shards is None:
        return Mesh(devs, axis)
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return Mesh([devs[p % len(devs)] for p in range(int(n_shards))], axis)


class RowSplit:
    """A row-split tensor: ``parts[p]`` holds shard p's rows on shard p's
    device, a tensor of its own.  The global row order is shard-major
    (shard 0's rows first).  It is no tensor: an operator takes its parts
    (``row_slices``), and a host copy of the whole (``np.asarray``) is for
    results and tests."""

    __slots__ = ("parts", "__weakref__")

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)

    @property
    def shape(self) -> tuple:
        return (sum(int(p.shape[0]) for p in self.parts),) + \
            tuple(self.parts[0].shape[1:])

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """Shard 0's device, where replicated values live."""
        return self.parts[0].device

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([p.cpu().numpy() for p in self.parts])
        return out if dtype is None else out.astype(dtype, copy=False)

    def __repr__(self) -> str:
        return (f"RowSplit({len(self.parts)} parts, {self.shape}, "
                f"{self.dtype})")


def shard_rows(mesh: Mesh, t) -> RowSplit:
    """``t`` split by rows across the mesh: shard p's rows [p * n_loc,
    (p + 1) * n_loc) copied to ``mesh.device(p)`` as a tensor of their own
    (its row count a multiple of the shard count: the storage layer pads
    tables to one).  A RowSplit of the mesh's shape is returned as it
    is."""
    nsh = mesh.size
    if isinstance(t, RowSplit):
        if len(t.parts) != nsh:
            raise ValueError(f"{len(t.parts)} parts for {nsh} shards")
        return t
    t = torch.as_tensor(t)
    if t.shape[0] % nsh:
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{nsh} shards")
    n_loc = t.shape[0] // nsh
    return RowSplit([t[p * n_loc:(p + 1) * n_loc].to(mesh.device(p),
                                                     copy=True)
                     for p in range(nsh)])


def row_slices(mesh: Mesh, t) -> list:
    """Shard p's rows for every p: a RowSplit's parts or a list of one
    tensor (or None) per shard as they are (no copy), a plain tensor split
    by ``shard_rows``; None stays None for every shard."""
    if t is None:
        return [None] * mesh.size
    if isinstance(t, (list, tuple)):
        if len(t) != mesh.size:
            raise ValueError(f"{len(t)} parts for {mesh.size} shards")
        return list(t)
    return shard_rows(mesh, t).parts


def rows_per_shard(parts: Sequence[torch.Tensor]) -> int:
    """n_loc of a row-split value's parts, every part being as long (the
    storage layer pads tables to a multiple of the mesh)."""
    n_loc = int(parts[0].shape[0])
    if any(int(t.shape[0]) != n_loc for t in parts):
        raise ValueError("table rows must be padded to a multiple of the "
                         "mesh")
    return n_loc


# -- collectives: one tensor per shard in, in shard order -------------------

def _to_first(xs: Sequence[torch.Tensor]) -> list:
    dev = xs[0].device
    return [x.to(dev) for x in xs]


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = False
               ) -> torch.Tensor:
    """Every shard's tensor, replicated on shard 0's device: stacked on a
    new leading axis (nsh, ...), or concatenated along axis 0 when
    ``tiled``."""
    parts = _to_first(xs)
    return torch.cat(parts) if tiled else torch.stack(parts)


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over the shards on shard 0's device, added in shard order."""
    return reduce(torch.add, _to_first(xs))


def pmin(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return reduce(torch.minimum, _to_first(xs))


def pmax(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return reduce(torch.maximum, _to_first(xs))


def all_to_all(xs: Sequence[torch.Tensor]) -> list:
    """Tiled all-to-all along axis 0: shard q's tensor is nsh blocks of
    equal rows, block p bound for shard p; shard p receives on its own
    device the blocks bound for it, from shard 0 first."""
    nsh = len(xs)
    cap = xs[0].shape[0] // nsh
    out = []
    for p in range(nsh):
        dev = xs[p].device
        out.append(torch.cat([xs[q][p * cap:(p + 1) * cap].to(dev)
                              for q in range(nsh)]))
    return out


def ppermute(xs: Sequence[torch.Tensor], perm) -> list:
    """Shard ``dst`` receives shard ``src``'s tensor on its own device for
    each (src, dst) of ``perm``; a shard that is no destination receives
    zeros."""
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return out
