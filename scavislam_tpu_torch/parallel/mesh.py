"""A ("dp", "sp") device mesh in one process (the port's counterpart of the
twin's ``jax.sharding.Mesh`` under ``shard_map``).

JAX's ``shard_map`` runs one program per device from one process that owns
every device. The port does the same with explicit devices: a
:class:`Mesh` is a (dp, sp) grid of ``torch.device``; a build function
splits its global inputs by the twin's partition specs, moves each shard
to its device, launches every shard's work, and only then reduces. A ``psum``
becomes :meth:`MeshAxis.psum`: the shard partials summed in fixed shard
order on shard 0's device and copied back to every shard, so the result is
the same on every run. Global outputs are gathered to the mesh's first
device. No ``torch.distributed`` process group is involved.

The devices are normally the first n CUDA cards. An explicit list stands in
for more cards than the machine has (one card listed n times, or the CPU
device n times in the tests), as XLA's forced host device count does for
the twin; the split and the sums are then exercised on that one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

AXES = ("dp", "sp")


class Mesh:
    """A (dp, sp) grid of torch devices with the twin's axis names;
    ``shape`` maps each axis name to its size."""

    def __init__(self, devices):
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for i, row in enumerate(devices):
            if len(row) != grid.shape[1]:
                raise ValueError("mesh rows must have equal lengths")
            for j, d in enumerate(row):
                grid[i, j] = torch.device(d)
        self.devices = grid
        self.shape = dict(zip(AXES, grid.shape))

    @property
    def first(self) -> torch.device:
        """The device global outputs are gathered to."""
        return self.devices[0, 0]

    def axis(self, name: str) -> "MeshAxis":
        """The shard group along `name` (at index 0 of the other axis)."""
        if name not in AXES:
            raise ValueError(f"axis {name!r} not in {AXES}")
        return MeshAxis(self, name)

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int = None, dp: int = None, devices=None) -> Mesh:
    """A ("dp", "sp") mesh over `devices` (default: the CUDA cards), the
    first `n_devices` of them (default: all). With `dp` None, the twin's
    split: streams first, sp = 2 when n is even (dp = n // 2), else sp = 1;
    otherwise sp = n // dp."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card; pass devices= "
                               "(e.g. ['cpu'] * n) to build a mesh without "
                               "one")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devices)} "
                         "present")
    devices = devices[:n]
    if dp is None:
        dp = n if n % 2 else n // 2
        sp = 1 if n % 2 else 2
    else:
        if dp < 1 or n % dp:
            raise ValueError(f"make_mesh: dp={dp} does not divide {n}")
        sp = n // dp
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)])


def _map(fn, x):
    """fn over the tensors of a nested tuple / NamedTuple (other leaves
    pass through)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        out = [_map(fn, v) for v in x]
        return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
    return x


def _zip_map(fn, xs):
    """fn(list of corresponding tensors) over nested structures."""
    first = xs[0]
    if isinstance(first, torch.Tensor):
        return fn(xs)
    if isinstance(first, tuple):
        out = [_zip_map(fn, list(vs)) for vs in zip(*xs)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return first


def to_device(x, device):
    """Every tensor of a nested structure on `device`."""
    return _map(lambda t: t.to(device), x)


def split(x, n: int, device_of, dim: int = 0):
    """x split into n equal chunks along `dim` (tensors of a nested
    structure; host lists are sliced), chunk k moved to device_of(k).
    Raises ValueError when the size does not divide."""
    def size(v):
        if isinstance(v, torch.Tensor):
            return v.shape[dim]
        if isinstance(v, tuple) and v:
            return size(v[0])
        return len(v)

    total = size(x)
    if total % n:
        raise ValueError(f"axis of size {total} does not split into {n} "
                         "equal shards")
    k = total // n

    def chunk(v, i):
        if isinstance(v, torch.Tensor):
            return v.narrow(dim, i * k, k).to(device_of(i))
        if isinstance(v, tuple):
            out = [chunk(e, i) for e in v]
            return type(v)(*out) if hasattr(v, "_fields") else tuple(out)
        return list(v)[i * k:(i + 1) * k]

    return [chunk(x, i) for i in range(n)]


def gather(parts, device, dim: int = 0):
    """The shards' outputs concatenated along `dim` on `device`."""
    return _zip_map(lambda ts: torch.cat([t.to(device) for t in ts], dim),
                    parts)


class MeshAxis(NamedTuple):
    """One axis of a mesh as a shard group: the mesh and the axis name.
    Its devices are the axis's row (or column) at index 0 of the other
    axis."""

    mesh: Mesh
    name: str

    @property
    def devices(self) -> list:
        g = self.mesh.devices
        return list(g[:, 0] if self.name == "dp" else g[0, :])

    @property
    def size(self) -> int:
        return self.mesh.shape[self.name]

    def psum(self, parts, devices=None):
        """The sum of the shard partials (one nested structure of tensors
        per shard, in shard order) on shard 0's device, copied back to
        every shard: a list with one sum per shard."""
        devices = self.devices if devices is None else devices
        d0 = devices[0]

        def add(ts):
            acc = ts[0].to(d0)
            for t in ts[1:]:
                acc = acc + t.to(d0)
            return acc

        total = _zip_map(add, parts)
        return [to_device(total, d) for d in devices]
