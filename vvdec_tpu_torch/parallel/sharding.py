"""Device-mesh sharding for the decode pipeline.

Port of vvdec_tpu/parallel/sharding.py: CTU-row sharding with a halo
exchange for the in-loop filter stencils (the reference's CTU wavefront,
P3) and frame-axis data parallelism for per-frame stages (P2).

One process drives every device of the mesh, as `shard_map` does under
JAX's single controller: a shard is a tensor on its mesh device, a halo
exchange copies a neighbour's boundary rows to the shard's device
(`Tensor.to`), and the launches on different devices run concurrently
because CUDA launches return at once.  The mesh is not built on
torch.distributed process groups: NCCL refuses two ranks on one card, and
a mesh may name one card several times.  A mesh's devices are whatever
the caller lists, repeats allowed; by default every visible CUDA card.
It never drops to the CPU and never shrinks on its own.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """An ndarray of torch.device with one name per axis: the counterpart
    of jax.sharding.Mesh.  `shape[axis]` is the size of that axis."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [torch.device(d) for d in grid.flat]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device array needs "
                             f"as many axis names, got {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str, **at) -> list:
        """The devices along `axis`, the other axes at the indices `at`
        names (0 where it names none)."""
        if axis not in self.shape:
            raise ValueError(f"the mesh has no axis {axis!r}: "
                             f"{self.axis_names}")
        idx = tuple(slice(None) if name == axis else at.get(name, 0)
                    for name in self.axis_names)
        return list(self.devices[idx])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_decode_mesh(n_devices: int | None = None, rows: int | None = None,
                     devices=None) -> Mesh:
    """Mesh over ("frame", "row"): frame-parallel x CTU-row-parallel.

    devices: the devices to lay out, repeats allowed (e.g. ["cuda:0"] * 4
    on one card, ["cpu"] * 8 in tests); default every visible CUDA card.
    n_devices: how many of them to use (default all).  rows: the row
    axis size (default 2 when n_devices is even and above 1, else 1); it
    must divide n_devices.  Raises rather than shrink the mesh."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_decode_mesh: CUDA is not available; "
                               "pass devices= to lay out others")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"make_decode_mesh: no device {d} (this host "
                             f"sees {torch.cuda.device_count()} cards)")
    n = len(devices) if n_devices is None else n_devices
    if not 1 <= n <= len(devices):
        raise ValueError(f"make_decode_mesh: {n} devices asked of "
                         f"{len(devices)}")
    if rows is None:
        rows = 2 if n % 2 == 0 and n > 1 else 1
    if rows < 1 or n % rows:
        raise ValueError(f"make_decode_mesh: {rows} rows do not divide "
                         f"{n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n // rows, rows), ("frame", "row"))


def halo_rows(shards: list, i: int, hrows: int):
    """Shard i of `shards` (consecutive row bands of one plane, each on
    its own device) with `hrows` rows of each neighbour copied to its
    device above and below it; the picture-edge shards replicate their
    border row instead."""
    xs = shards[i]
    if i == 0:
        top = xs[:1].expand(hrows, -1)
    else:
        top = shards[i - 1][-hrows:].to(xs.device)
    if i == len(shards) - 1:
        bot = xs[-1:].expand(hrows, -1)
    else:
        bot = shards[i + 1][:hrows].to(xs.device)
    return torch.cat([top, xs, bot])


def _split(x, n: int, devices: list) -> list:
    """x cut into n equal bands along dim 0, band k on devices[k]."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} shards")
    s = x.shape[0] // n
    return [x[k * s:(k + 1) * s].to(devices[k]) for k in range(n)]


def halo_map_rows(fn, x, halo: int, mesh: Mesh, axis: str = "row"):
    """Apply `fn(padded_shard) -> filtered_shard` over row shards of a
    plane [H, W] along `mesh[axis]`, each shard on its mesh device with
    `halo` boundary rows of its neighbours (picture-edge shards see their
    border row replicated, as a whole-frame filter's edge padding is).
    `fn` receives [H / n + 2 * halo, W] and returns the filtered core
    [H / n, W]; the result is gathered on x's device."""
    devs = mesh.axis_devices(axis)
    shards = _split(x, len(devs), devs)
    outs = [fn(halo_rows(shards, k, halo)) for k in range(len(shards))]
    return torch.cat([o.to(x.device) for o in outs])


def _tree_map(fn, tree):
    """fn over the leaves of nested tuples and lists."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _gather(outs: list, home):
    """The bands' outputs (alike nested tuples of tensors) joined along
    dim 0 on `home`."""
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(_gather([o[j] for o in outs], home)
                             for j in range(len(outs[0])))
    return torch.cat([o.to(home) for o in outs])


def frame_parallel(fn, batch, mesh: Mesh, axis: str = "frame"):
    """Run a per-frame stage over the frame axis of the mesh: `batch` (a
    tensor, or nested tuples of tensors and numpy arrays, each with a
    leading frame axis) is cut into one band of frames per device along
    `mesh[axis]`, tensors moved to that device and numpy arrays kept on
    the host; fn(band) returns a tensor or nested tuples of tensors with
    the same leading axis, gathered on the device of the batch's first
    tensor."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    leaves = []
    _tree_map(leaves.append, batch)
    home = next(x.device for x in leaves if isinstance(x, torch.Tensor))
    if any(x.shape[0] % n for x in leaves):
        raise ValueError(f"a leading axis of {[x.shape[0] for x in leaves]}"
                         f" frames does not split into {n} shards")

    def band(x, k: int):
        s = x.shape[0] // n
        part = x[k * s:(k + 1) * s]
        return part.to(devs[k]) if isinstance(x, torch.Tensor) else part

    return _gather([fn(_tree_map(lambda x: band(x, k), batch))
                    for k in range(n)], home)


def vertical_121(padded):
    """[1 2 1] vertical smoothing on a halo-padded shard (halo = 1); the
    stencil shape of the deblock/SAO boundary reads."""
    core = padded[1:-1, :]
    return (padded[:-2, :] + 2 * core + padded[2:, :] + 2) >> 2
