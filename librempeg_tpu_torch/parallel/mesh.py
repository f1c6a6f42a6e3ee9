"""Device mesh of the port: shards over named axes, driven by one process.

Port of librempeg_tpu/parallel/mesh.py. The JAX package lays a
jax.sharding.Mesh over its devices and lets XLA insert the collectives;
the port has no such compiler, so its mesh and its collectives are
explicit.

Device model. One process drives every shard, as JAX's single
controller runs a shard_map over all its devices (and as the JAX tests
run 8 virtual CPU devices in one process). torch.distributed would need
a process per rank, NCCL cannot put two ranks on one card, and the CPU
tests would have to spawn process groups under xdist.

- A Mesh is a numpy object array of Shards with axis names. A shard has
  a torch.device and, on CUDA, a stream of its own; work for a shard is
  issued on its stream (Shard.ctx), and the order between shards comes
  from events.
- make_mesh without `devices` gives the shards distinct devices,
  cuda:0 .. cuda:k-1, and raises when the machine has fewer: nothing
  shrinks on its own. `devices=[...]` is the caller's explicit list and
  may repeat a device (the counterpart of XLA's forced host device
  count): the tests pass ["cpu"] * n, and a one-card machine may pass
  ["cuda:0"] * n, whose n shards then share that card (n streams of one
  device: the layout runs, but no scaling is measured by it). The CPU is
  one torch device, so a CPU mesh is always an explicit list.
- The collectives are copies between shards: ppermute is a copy to the
  destination shard's device on its stream after an event of the
  source's stream (to_shard), and the gather back to the caller a copy
  on the caller's stream after an event of the shard's (from_shard);
  the ring's closing psum (stagepipe.py) is such a gather. A JAX body
  that calls a collective midway (halo.py, stagepipe.py, sp_audio.py)
  is written here in the global view: per-shard compute, then the
  exchange over the list of shards, then per-shard compute.

Axes (as in the JAX package):
  data     frame/stream batch parallelism
  spatial  rows of a frame, with halo exchange for taps that cross
           shard borders
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch


def factor2(n: int, max_second: int = 4) -> tuple[int, int]:
    """Split n into (a, b) with b <= max_second, b | n, b maximal."""
    for b in range(min(n, max_second), 0, -1):
        if n % b == 0:
            return n // b, b
    return n, 1


class Shard:
    """One position of a mesh: its index along each axis, its device and,
    on CUDA, its own stream."""

    def __init__(self, index: tuple, device: torch.device):
        self.index = index
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def ctx(self):
        """Issue the enclosed work on this shard's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def __repr__(self) -> str:
        return f"Shard({self.index}, {self.device})"


class Mesh:
    """A numpy object array of Shards over named axes."""

    def __init__(self, shards: np.ndarray, axis_names: tuple):
        if shards.ndim != len(axis_names):
            raise ValueError(f"mesh of {shards.ndim} dims for axes "
                             f"{axis_names}")
        self.shards = shards
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """{axis name: size}, like jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.shards.shape))

    @property
    def size(self) -> int:
        return self.shards.size

    def shard(self, **index) -> Shard:
        """The shard at {axis: i}; axes not named take index 0."""
        unknown = set(index) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh has no axis {sorted(unknown)}")
        return self.shards[tuple(index.get(a, 0) for a in self.axis_names)]

    def along(self, axis: str, **index) -> list[Shard]:
        """The shards along `axis`, every other axis at `index` (0 when
        not named)."""
        return [self.shard(**{**index, axis: i})
                for i in range(self.shape[axis])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[s.device for s in self.shards.flat]})"


def _distinct(n: int, device: torch.device) -> list[torch.device]:
    if device.type != "cuda":
        raise ValueError(
            f"make_mesh: the {device.type} is one torch device, so a mesh "
            f"on it needs an explicit devices=[...] list")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"make_mesh: asked for {n} distinct cuda devices but this "
            f"machine has {have}; refusing to silently build a smaller "
            f"mesh (pass devices=[...] to put shards on one device)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None,
              axes: tuple = ("data", "spatial"),
              shape: tuple | None = None, *, device="cuda",
              devices=None) -> Mesh:
    """A mesh of n_devices shards over `axes` (shape: factor2(n) for two
    axes unless given). Without `devices` the shards take distinct
    devices of `device`'s type, cuda:0 .. cuda:n-1; `devices` is an
    explicit list, which may repeat a device."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if len(devs) < n_devices:
                raise ValueError(
                    f"make_mesh: asked for {n_devices} shards but the "
                    f"device list has {len(devs)}")
            devs = devs[:n_devices]
    else:
        n = n_devices if n_devices is not None else (
            int(np.prod(shape)) if shape is not None else None)
        if n is None:
            raise ValueError("make_mesh: give n_devices, shape or devices")
        devs = _distinct(n, torch.device(device))
    n = len(devs)
    if shape is None:
        if len(axes) != 2:
            raise ValueError("make_mesh: give a shape for other than 2 axes")
        shape = factor2(n)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh {tuple(shape)} != {n} devices")
    shards = np.empty(tuple(shape), dtype=object)
    for k, idx in enumerate(itertools.product(*(range(s) for s in shape))):
        shards[idx] = Shard(idx, devs[k])
    return Mesh(shards, tuple(axes))


def to_shard(x: torch.Tensor, dst: Shard, src: Shard | None = None
             ) -> torch.Tensor:
    """ppermute's counterpart: `x` on dst's device, ordered on dst's
    stream after the work that made it (on src's stream, or on the
    current stream of x's device when src is None). The result may be x
    itself when the devices are the same."""
    src_stream = src.stream if src is not None else (
        torch.cuda.current_stream(x.device) if x.is_cuda else None)
    if dst.stream is None:
        if src_stream is None:
            return x.to(dst.device)
        with torch.cuda.stream(src_stream):
            return x.to(dst.device)
    if src_stream is not None:
        dst.stream.wait_stream(src_stream)
    with dst.ctx():
        y = x.to(dst.device, non_blocking=x.is_cuda)
    if x.is_cuda:
        x.record_stream(dst.stream)
    return y


def from_shard(x: torch.Tensor, src: Shard, device) -> torch.Tensor:
    """`x`, made on src's stream, on `device`, ordered on that device's
    current stream (the gather back to the caller)."""
    device = torch.device(device)
    if src.stream is None:
        return x.to(device)
    if device.type != "cuda":
        with src.ctx():
            return x.to(device)
    dst = torch.cuda.current_stream(device)
    dst.wait_stream(src.stream)
    with torch.cuda.stream(dst):
        y = x.to(device, non_blocking=True)
    x.record_stream(dst)
    return y


def frame_sharding(mesh: Mesh, spatial: bool = True):
    """Split and gather of [N, H, W] frame batches: the batch over
    'data' and, with `spatial`, the rows over 'spatial' (the JAX
    package's NamedSharding P('data', 'spatial', None)). Returns
    (split, gather): split(x) -> object array of per-shard tensors in
    the mesh's shape; gather(parts, device) -> [N, H, W] on device."""
    return _Sharding(mesh, ("data", "spatial") if spatial else ("data",))


def replicated(mesh: Mesh):
    """Every shard holds the whole tensor (P()): split(x) copies x to each
    shard; gather takes shard 0's copy."""
    return _Sharding(mesh, ())


class _Sharding:
    """Splits a tensor's leading axes over named mesh axes (axis k of
    `over` splits tensor axis k); mesh axes not named replicate."""

    def __init__(self, mesh: Mesh, over: tuple):
        self.mesh = mesh
        self.over = tuple(a for a in over if a in mesh.axis_names)

    def _part(self, x, shard: Shard):
        for k, axis in enumerate(self.over):
            n = self.mesh.shape[axis]
            i = shard.index[self.mesh.axis_names.index(axis)]
            if x.shape[k] % n:
                raise ValueError(f"axis {k} of {tuple(x.shape)} does not "
                                 f"split over {axis}={n}")
            step = x.shape[k] // n
            x = x.narrow(k, i * step, step)
        return x

    def split(self, x: torch.Tensor) -> np.ndarray:
        parts = np.empty(self.mesh.shards.shape, dtype=object)
        for idx, shard in np.ndenumerate(self.mesh.shards):
            parts[idx] = to_shard(self._part(x, shard), shard)
        return parts

    def gather(self, parts: np.ndarray, device) -> torch.Tensor:
        """The inverse of split, from the shards at index 0 of every mesh
        axis not split over."""
        def take(prefix: tuple) -> torch.Tensor:
            k = len(prefix)
            if k == len(self.over):
                sh = self.mesh.shard(**dict(zip(self.over, prefix)))
                return from_shard(parts[sh.index], sh, device)
            return torch.cat([take(prefix + (i,))
                              for i in range(self.mesh.shape[self.over[k]])],
                             dim=k)

        return take(())
