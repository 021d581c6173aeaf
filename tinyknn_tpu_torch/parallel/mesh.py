"""Device-mesh helpers (counterpart of tinyknn_tpu/parallel/mesh.py).

The JAX package lays its arrays over a ``jax.sharding.Mesh`` and runs
one program on all of its devices. The port keeps that single-process
shape with plain torch: a ``Mesh`` is an array of ``torch.device`` with
named axes, a ``Placed`` is one logical array held as one tensor per
mesh position, and the sharded indexes call their per-shard function
once per position, on that position's device.

A device may appear at several positions of a mesh: the positions are
then logical shards that run one after another on that device. That is
how several shards run on one card, or on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """An n-d array of ``torch.device`` with one name per axis."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names) or devices.size == 0:
            raise ValueError(f"a mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names and a device, not "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self, axis: str, query_axis: str | None = None):
        """The mesh positions (index tuples into ``devices``) as rows of
        shards: row r holds, in shard order, the positions at index r of
        ``query_axis`` (one row when it is None). Every other axis is
        taken at index 0: positions along it would repeat the same
        work."""
        for name in (axis, query_axis):
            if name is not None and name not in self.axis_names:
                raise ValueError(f"the mesh has axes {self.axis_names}, "
                                 f"not {name!r}")
        n_rows = self.shape[query_axis] if query_axis else 1
        return [[tuple(s if name == axis else r if name == query_axis else 0
                       for name in self.axis_names)
                 for s in range(self.shape[axis])] for r in range(n_rows)]

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"


class Placed:
    """A logical array laid out over a mesh, one tensor per position.

    ``parts`` has the mesh's shape; ``parts[pos]`` lives on
    ``mesh.devices[pos]``. ``axis``: the mesh axis that dim 0 is split
    over (every position at index s of it holds slice s), or None for an
    array replicated whole. Positions that agree in device and slice
    share one tensor."""

    def __init__(self, mesh: Mesh, parts: np.ndarray, axis: str | None):
        self.mesh = mesh
        self.parts = parts
        self.axis = axis

    def __getitem__(self, pos) -> torch.Tensor:
        return self.parts[pos]

    @property
    def shape(self) -> tuple:
        """The logical array's shape: the slices stacked on dim 0."""
        part = self.parts.flat[0]
        if self.axis is None:
            return tuple(part.shape)
        n = self.mesh.shape[self.axis]
        return (n * part.shape[0],) + tuple(part.shape[1:])

    def shards(self) -> list:
        """The slices in order along ``axis`` (the whole array, once, when
        replicated)."""
        if self.axis is None:
            return [self.parts.flat[0]]
        return [self.parts[pos] for pos in self.mesh.grid(self.axis)[0]]


def _device(spec) -> torch.device:
    dev = torch.device(spec)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _devices(n, devices) -> list:
    """The first ``n`` of ``devices`` (all when n is None); by default the
    visible CUDA devices. No CPU stands in for a missing card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for the mesh; name the devices to use "
                "(devices=[...]; a device may repeat)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n is not None:
        if n > len(devices):
            raise ValueError(f"need {n} devices, have {len(devices)}")
        devices = devices[:n]
    return devices


def make_mesh(n_devices=None, axis: str = "shards", devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: the
    visible CUDA devices, all of them). ``devices`` may name one device
    several times."""
    return Mesh(_devices(n_devices, devices), (axis,))


def make_mesh_2d(shape, axis_names=("queries", "shards"),
                 devices=None) -> Mesh:
    """2-D mesh: axis 0 splits the query batch (pure data parallelism),
    axis 1 shards the inverted lists. Results are merged along axis 1
    only; axis 0 needs no communication."""
    devs = np.empty(shape[0] * shape[1], dtype=object)
    devs[:] = _devices(shape[0] * shape[1], devices)
    return Mesh(devs.reshape(shape), tuple(axis_names))


def place(mesh: Mesh, shards, axis: str) -> Placed:
    """Lay the per-shard tensors ``shards`` (one per index of ``axis``)
    over the mesh: each goes once to every distinct device that holds a
    position of its shard."""
    if len(shards) != mesh.shape[axis]:
        raise ValueError(f"{len(shards)} shards for a mesh axis of "
                         f"{mesh.shape[axis]}")
    where = mesh.axis_names.index(axis)
    parts = np.empty(mesh.devices.shape, dtype=object)
    copies = {}
    for pos in np.ndindex(mesh.devices.shape):
        key = (mesh.devices[pos], pos[where])
        if key not in copies:
            copies[key] = shards[pos[where]].to(mesh.devices[pos])
        parts[pos] = copies[key]
    return Placed(mesh, parts, axis)


def shard_on_axis0(mesh: Mesh, *arrays, axis: str = "shards"):
    """Place arrays with dim 0 split evenly over the mesh axis."""
    n = mesh.shape[axis]
    out = []
    for a in arrays:
        if a.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(a.shape)} does not divide "
                             f"over {n} shards")
        out.append(place(mesh, a.reshape((n, -1) + tuple(a.shape[1:])),
                         axis))
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, *arrays):
    """Replicate arrays over the mesh: one copy per distinct device."""
    out = []
    for a in arrays:
        parts = np.empty(mesh.devices.shape, dtype=object)
        copies = {}
        for pos in np.ndindex(mesh.devices.shape):
            dev = mesh.devices[pos]
            if dev not in copies:
                copies[dev] = a.to(dev)
            parts[pos] = copies[dev]
        out.append(Placed(mesh, parts, None))
    return out if len(out) > 1 else out[0]
