"""Device meshes and sharded states for spatial domain decomposition
(counterpart of lbm_tpu/parallel/mesh.py).

lbm_tpu builds a ``jax.sharding.Mesh`` over axes ('x', 'y') from one
process's devices and shards a field as P(None, 'x', 'y'): population
planes whole, rows over 'x', columns over 'y'.  The port keeps that
decomposition as a single-process mesh over a list of torch devices.  One
process drives every shard: the shards of one card share it (``["cuda:0"]
* n``), the shards of several cards each sit on their own, and the halo
copies go device to device (parallel/halo.py).  The CPU tests use
``["cpu"] * 8`` where lbm_tpu uses 8 virtual devices.

A ``ShardedState`` holds the shards of one field in row-major mesh order;
the sharded steps (parallel/sharded.py, kernels/sharded.py) take one and
return one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

@dataclass(frozen=True)
class Mesh:
    """An (nx, ny) grid of torch devices: rows of the field over 'x', its
    columns over 'y'.  ``devices[i][j]`` holds shard (i, j); a device may
    appear more than once."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        """{'x': nx, 'y': ny}, as a JAX mesh's ``shape``."""
        return {"x": len(self.devices), "y": len(self.devices[0])}

    @property
    def flat(self) -> tuple[torch.device, ...]:
        """The devices in row-major order, the order of ``ShardedState.shards``."""
        return tuple(d for row in self.devices for d in row)


def make_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """Build an ('x', 'y') mesh from a list of devices.

    ``devices=None`` means every CUDA device of the process; without one
    this raises (there is no CPU mesh by default: pass ``["cpu"] * n``).
    ``shape`` fixes (nx, ny); the default splits all devices along 'x'
    (rows), the long axis of the reference's workloads."""
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise RuntimeError("make_mesh(): no CUDA device; pass a device list such as "
                               "['cpu'] * 8 for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    nx, ny = shape
    if nx * ny != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(tuple(tuple(devices[i * ny:(i + 1) * ny]) for i in range(nx)))


def shard_layout(mesh: Mesh, R: int, C: int) -> list[tuple[torch.device, slice, slice]]:
    """Where each shard of an (R, C) grid lives: (device, rows, cols) in
    row-major mesh order (lbm_tpu's FIELD_SPEC / SCALAR_SPEC: rows over 'x',
    columns over 'y').  Uneven splits raise."""
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    if R % nx:
        raise ValueError(f"rows {R} not divisible by mesh x={nx}")
    if C % ny:
        raise ValueError(f"cols {C} not divisible by mesh y={ny}")
    r, c = R // nx, C // ny
    return [(mesh.devices[i][j], slice(i * r, (i + 1) * r), slice(j * c, (j + 1) * c))
            for i in range(nx) for j in range(ny)]


@dataclass
class ShardedState:
    """The shards of one field, ``(planes, R_loc, C_loc)`` or ``(R_loc,
    C_loc)`` each, in row-major mesh order, each on its mesh device."""

    mesh: Mesh
    shards: list

    def grid(self, i: int, j: int = 0) -> torch.Tensor:
        """Shard (i, j)."""
        return self.shards[i * self.mesh.shape["y"] + j]

    def gather(self, device=None) -> torch.Tensor:
        """The whole field on ``device`` (default: the first shard's)."""
        device = self.shards[0].device if device is None else torch.device(device)
        nx, ny = self.mesh.shape["x"], self.mesh.shape["y"]
        rows = [torch.cat([self.grid(i, j).to(device) for j in range(ny)], dim=-1)
                for i in range(nx)]
        return torch.cat(rows, dim=-2)


def shard_state(mesh: Mesh, f: torch.Tensor) -> ShardedState:
    """Split a ``(planes, R, C)`` or ``(R, C)`` tensor into the mesh's
    shards, each a contiguous copy on its device."""
    if f.ndim not in (2, 3):
        raise ValueError(f"shard_state takes (planes, R, C) or (R, C), got {tuple(f.shape)}")
    layout = shard_layout(mesh, f.shape[-2], f.shape[-1])
    return ShardedState(mesh, [f[..., rows, cols].to(dev, copy=True,
                                                     memory_format=torch.contiguous_format)
                               for dev, rows, cols in layout])
