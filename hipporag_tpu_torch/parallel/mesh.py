"""Device meshes of the port (counterpart of ``hipporag_tpu/parallel/mesh.py``).

The framework's two parallel axes, as in the JAX package:

- ``dp``: data parallelism over the *query batch*;
- ``corpus``: sharding of the corpus-sized axes: passage/fact embedding
  rows and graph nodes/edges.

The port is single-controller, as the JAX package is: one process holds a
``[dp, corpus]`` array of ``torch.device`` and runs every shard itself
(``parallel/sharded.py``); the collectives are explicit copies and
reductions across the per-shard tensors (``parallel/collectives.py``). A
device may repeat in the array: such *virtual shards* are the counterpart
of JAX's ``--xla_force_host_platform_device_count`` CPU devices, and let one
GPU (or the CPU) run every exchange path of a multi-device mesh. On a
machine with several GPUs the same code puts the shards on separate cards.

A placement (:class:`Sharding`, built by :func:`replicated`,
:func:`corpus_sharded`, :func:`batch_sharded`) lays a tensor out as a
``grid[g][c]`` of blocks, the block that mesh device ``(g, c)`` holds. A
block is copied once per distinct device: virtual shards on one device
share it, and a block of a tensor that already lies on its device is a
view, not a copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

DP_AXIS = "dp"
CORPUS_AXIS = "corpus"


class Mesh(NamedTuple):
    """``devices``: a ``[dp, corpus]`` object array of ``torch.device``."""

    devices: np.ndarray
    axis_names: tuple = (DP_AXIS, CORPUS_AXIS)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def dp(self) -> int:
        return int(self.devices.shape[0])

    @property
    def corpus(self) -> int:
        return int(self.devices.shape[1])

    @property
    def size(self) -> int:
        return int(self.devices.size)


def visible_devices() -> list:
    """The visible CUDA devices, or the CPU when there is none."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]


def mesh_devices_for(n: int, device, mesh_devices: Optional[Sequence] = None) -> list:
    """The ``n`` devices of a mesh for an entry point running on ``device``.

    ``mesh_devices`` is taken as given (repeats allowed: virtual shards);
    else the CPU gives ``n`` copies of itself and CUDA the first ``n``
    visible cards. Too few cards is a ``RuntimeError``, as in the JAX package.
    """
    if mesh_devices is not None:
        devices = [torch.device(d) for d in mesh_devices]
        if len(devices) != n:
            raise ValueError(f"mesh_devices holds {len(devices)} devices, the mesh needs {n}")
        return devices
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    visible = torch.cuda.device_count()
    if visible < n:
        raise RuntimeError(
            f"a mesh of {n} devices needs {n} CUDA devices but only {visible} are visible; "
            "pass mesh_devices (repeats allowed) or set mesh_shape=(1, 1) for single-device retrieval"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(mesh_shape: Optional[Sequence[int]] = None, devices=None) -> Mesh:
    """Build a ("dp", "corpus") mesh over ``devices`` (default: :func:`visible_devices`)."""
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if mesh_shape is None:
        # default: all devices on the corpus axis. An EXPLICIT shape is
        # always honored exactly: (1, 1) over several devices is a mismatch
        mesh_shape = (1, n)
    dp, corpus = mesh_shape
    if dp * corpus != n:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not match {n} devices")
    arr = np.empty((dp, corpus), dtype=object)
    for i, d in enumerate(devices):
        arr[i // corpus, i % corpus] = d
    return Mesh(arr)


def make_hybrid_mesh(dp_slices: Optional[int] = None, devices=None) -> Mesh:
    """("dp", "corpus") mesh with dp as the leading axis.

    One process is one slice, so this is the JAX package's single-slice
    branch: ``dp_slices`` groups (default 1) over the devices. Its
    multi-slice branch (dp over the links between TPU slices) has no
    counterpart in one process.
    """
    if devices is None:
        devices = visible_devices()
    n = len(devices)
    dp = dp_slices or 1
    if n % dp != 0:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    return make_mesh((dp, n // dp), devices=devices)


class Sharding(NamedTuple):
    """A layout over ``mesh``: ``spec[i]`` names the mesh axis that splits
    tensor dimension ``i`` (``DP_AXIS``, ``CORPUS_AXIS`` or ``None``), as a
    JAX ``PartitionSpec`` does; dimensions past the spec are whole."""

    mesh: Mesh
    spec: tuple

    def place(self, x) -> list:
        """``x`` (a tensor or array) as ``grid[g][c]``: the block of ``x``
        that mesh device ``(g, c)`` holds, on that device, contiguous."""
        x = torch.as_tensor(x)
        parts = {DP_AXIS: self.mesh.dp, CORPUS_AXIS: self.mesh.corpus}
        for dim, axis in enumerate(self.spec):
            if axis is not None and x.shape[dim] % parts[axis]:
                raise ValueError(
                    f"dimension {dim} ({x.shape[dim]}) is not divisible by the {axis} axis ({parts[axis]})")
        copies = {}
        grid = []
        for g in range(self.mesh.dp):
            row = []
            for c in range(self.mesh.corpus):
                at = {DP_AXIS: g, CORPUS_AXIS: c}
                key = tuple(at[a] if a is not None else None for a in self.spec)
                dev = self.mesh.devices[g, c]
                if (key, dev) not in copies:
                    block = x
                    for dim, axis in enumerate(self.spec):
                        if axis is not None:
                            size = x.shape[dim] // parts[axis]
                            block = block.narrow(dim, at[axis] * size, size)
                    copies[key, dev] = block.to(dev).contiguous()
                row.append(copies[key, dev])
            grid.append(row)
        return grid


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def corpus_sharded(mesh: Mesh, axis: int = 0) -> Sharding:
    spec = [None] * (axis + 1)
    spec[axis] = CORPUS_AXIS
    return Sharding(mesh, tuple(spec))


def batch_sharded(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (DP_AXIS,))
