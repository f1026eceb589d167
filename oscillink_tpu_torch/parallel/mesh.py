"""Device meshes for row-sharded lattices, and the three collectives the
mesh tiers use (port of ``oscillink_tpu/parallel/mesh.py``).

The JAX mesh is one process over many devices; so is this one.  A `Mesh` is
a tuple of ``torch.device``s, one per shard, and a shard's tensors live on
its device.  A device may repeat: ``[torch.device("cuda:0")] * 4`` puts four
shards on one card (the halo exchange, the per-shard kernel launches and the
reduction order all run for real), as ``[torch.device("cpu")] * 8`` is the
counterpart of XLA's ``--xla_force_host_platform_device_count=8``.  With
shards on different cards the same code moves tensors by peer copies.

The collectives take and return lists of per-shard tensors, in shard order:

* `all_gather` — the shards' blocks concatenated in shard order, onto each
  shard's device.  Shards that share a device share one tensor: one copy of
  the gathered rows per device, never one per shard;
* `all_to_all` — ``recv[d][s] = send[s][d]``, moved to shard d's device;
* `psum` — the per-shard partials summed in shard order, then copied to
  every shard's device.  The order is fixed by construction, so a mesh
  tier's reductions round the same way on every run and every layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = ["Mesh", "lattice_mesh", "all_gather", "all_to_all", "psum", "split_rows",
           "gather_rows"]


class Mesh:
    """A 1-D mesh: one ``torch.device`` per shard and the axis name."""

    def __init__(self, devices: Sequence[torch.device], axis_name: str = "rows"):
        self.devices = tuple(devices)
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)


def _resolve(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def lattice_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
    axis_name: str = "rows",
) -> Mesh:
    """A 1-D mesh over ``n_devices`` of ``devices`` (default: every visible
    CUDA device; raises without CUDA).  A device may repeat."""
    if devices is None:
        _resolve("cuda")  # raises without CUDA
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [_resolve(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices but only {len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis_name)


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The blocks of ``parts`` concatenated along axis 0 in shard order, on
    each shard's device; shards on one device get the same tensor."""
    if len(parts) == 1:
        return [parts[0]]
    per_device: dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in mesh.devices:
        if dev not in per_device:
            per_device[dev] = torch.cat([p.to(dev) for p in parts], dim=0)
        out.append(per_device[dev])
    return out


def all_to_all(mesh: Mesh, send: Sequence[Sequence[torch.Tensor]]) -> list[list[torch.Tensor]]:
    """``recv[d][s] = send[s][d]``, on shard d's device."""
    n = mesh.size
    return [[send[s][d].to(mesh.devices[d]) for s in range(n)] for d in range(n)]


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Σ_s parts[s], added in shard order on shard 0's device, then copied to
    every shard's device (shards on one device share the tensor)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    per_device = {total.device: total}
    out = []
    for dev in mesh.devices:
        if dev not in per_device:
            per_device[dev] = total.to(dev)
        out.append(per_device[dev])
    return out


def split_rows(mesh: Mesh, x, dtype: Optional[torch.dtype] = None) -> list[torch.Tensor]:
    """Equal contiguous row blocks of ``x`` (a tensor on any device, or a
    numpy array), block s on shard s's device.  N must divide the mesh."""
    n = x.shape[0]
    if n % mesh.size != 0:
        raise ValueError(f"N={n} is not divisible by mesh size {mesh.size}")
    rows = n // mesh.size
    out = []
    for s, dev in enumerate(mesh.devices):
        blk = x[s * rows:(s + 1) * rows]
        if isinstance(blk, np.ndarray):
            blk = torch.from_numpy(np.ascontiguousarray(blk))
        out.append(blk.to(device=dev, dtype=dtype).contiguous())
    return out


def gather_rows(parts: Sequence[torch.Tensor], device: DeviceLike = "cpu") -> torch.Tensor:
    """The per-shard blocks concatenated in shard order on ``device`` (the
    host by default)."""
    dev = torch.device(device)
    return torch.cat([p.to(dev) for p in parts], dim=0)
