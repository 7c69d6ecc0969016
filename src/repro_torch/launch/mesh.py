"""Decode meshes: the devices a sharded decode runs over.

A :class:`DecodeMesh` is the port's counterpart of a ``jax.sharding.Mesh``
for the sharded decode executor (``repro_torch.parallel.decode_shard``):
a tuple of devices, flattened row-major, with axis names and sizes.  The
executor splits walk rows over the *product* of the axes, so a 1-D mesh
(:func:`make_decode_mesh`) and a 2-axis smoke mesh
(:func:`make_smoke_mesh`) are both valid.

An explicit device list may repeat a device: ``("cpu",) * 4`` is a 4-shard
mesh on the CPU, and ``("cuda:0",) * 4`` runs 4 shards one after another
on one card.  Such a list is the counterpart of the forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) the JAX package's
multi-device tests run on: the partition, the per-shard slabs and the
merge are those of a mesh of distinct devices, only serialised.

Building a mesh never touches a device until it is called, and with no
card a mesh over the visible CUDA devices raises instead of drifting to
the CPU.  A ``("pod",)`` mesh (:func:`make_pod_mesh`) carries the
cross-pod compressed train step, one device a pod.

The training side's production mesh (:func:`make_production_mesh`) is
16 x 16 ``("data", "model")``, or 2 x 16 x 16 with a ``"pod"`` axis.  No
one process holds 256 cards, so with no devices it is an
:class:`AbstractMesh`, axis names and sizes only (jax's ``AbstractMesh``):
the sharding rules (``parallel.sharding``) and the dry run
(``launch.dryrun``) read nothing else.  A :class:`Placement` (jax's
``NamedSharding``) cuts a tensor into one shard a mesh entry and puts it
back; the elastic restore (``CheckpointManager.restore(shardings=)``)
returns its leaves so.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device


class DecodeMesh:
    """Devices in row-major order over named axes (see module docstring).

    ``devices`` holds ``prod(sizes)`` entries, all of one device type (the
    walk wrappers choose the kernel or the plain walk by the tensors'
    device, so a mixed mesh would serve part of a decode on the CPU);
    ``shape`` maps each axis name to its size, as a jax mesh's does."""

    def __init__(self, devices, axis_names, sizes):
        self.devices = tuple(resolve_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(n) for n in sizes)
        if len(sizes) != len(self.axis_names) or min(sizes, default=0) < 1:
            raise ValueError(f"axes {self.axis_names} need one size >= 1 "
                             f"each, got {sizes}")
        if math.prod(sizes) != len(self.devices):
            raise ValueError(f"a {sizes} mesh needs {math.prod(sizes)} "
                             f"devices, got {len(self.devices)}")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("a mesh's devices must be of one type, got "
                             f"{sorted({d.type for d in self.devices})}")
        self.shape = dict(zip(self.axis_names, sizes))


class AbstractMesh:
    """A mesh described by its axis names and sizes alone, with no devices
    (jax's ``AbstractMesh``); ``shape`` maps each axis to its size."""

    devices = None

    def __init__(self, axis_names, sizes):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(n) for n in sizes)
        if len(sizes) != len(self.axis_names) or min(sizes, default=0) < 1:
            raise ValueError(f"axes {self.axis_names} need one size >= 1 "
                             f"each, got {sizes}")
        self.shape = dict(zip(self.axis_names, sizes))


class Placement:
    """``mesh`` and a resolved ``spec`` (one entry a tensor dimension:
    ``None``, an axis name, or a tuple of axis names, as a jax
    ``PartitionSpec`` holds them): the port's ``NamedSharding``.

    A dimension that names axes is cut into as many equal blocks as the
    product of their sizes, the first named axis the major one; a mesh
    entry's block is fixed by its coordinates on those axes, and entries
    that differ only on axes the spec does not name hold the same block
    (replicas)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)
        for axes in self._axes():
            for a in axes:
                if a not in mesh.shape:
                    raise ValueError(f"spec {self.spec} names {a!r}, not an "
                                     f"axis of {tuple(mesh.shape)}")

    def _axes(self):
        return [() if e is None else (e,) if isinstance(e, str) else tuple(e)
                for e in self.spec]

    def _entries(self, shape):
        """Each mesh entry's (device, slices of ``shape``), row-major."""
        if self.mesh.devices is None:
            raise ValueError("an abstract mesh has no devices to place on")
        if len(shape) != len(self.spec):
            raise ValueError(f"spec {self.spec} for a tensor of shape "
                             f"{tuple(shape)}")
        names = tuple(self.mesh.shape)
        sizes = [self.mesh.shape[a] for a in names]
        axes = self._axes()
        parts = [math.prod(self.mesh.shape[a] for a in ax) for ax in axes]
        for n, k in zip(shape, parts):
            if n % k:
                raise ValueError(f"dimension {n} does not split into {k} "
                                 f"blocks (spec {self.spec})")
        out = []
        for flat, dev in enumerate(self.mesh.devices):
            coord, rest = {}, flat
            for a, n in zip(reversed(names), reversed(sizes)):
                coord[a] = rest % n
                rest //= n
            slices = []
            for n, k, ax in zip(shape, parts, axes):
                block = 0
                for a in ax:
                    block = block * self.mesh.shape[a] + coord[a]
                slices.append(slice(block * (n // k), (block + 1) * (n // k)))
            out.append((dev, tuple(slices)))
        return out

    def shard(self, t: torch.Tensor) -> list:
        """``t`` cut into its shards, one a mesh entry in row-major order,
        each on its entry's device."""
        return [t[sl].to(dev, copy=True).contiguous()
                for dev, sl in self._entries(t.shape)]

    def gather(self, shards) -> torch.Tensor:
        """The whole tensor back from :meth:`shard`'s list, on the first
        entry's device."""
        first = shards[0]
        shape = [n * math.prod(self.mesh.shape[a] for a in ax)
                 for n, ax in zip(first.shape, self._axes())]
        dev = self.mesh.devices[0]
        out = torch.empty(shape, dtype=first.dtype, device=dev)
        for (_, sl), s in zip(self._entries(shape), shards):
            out[sl] = s.to(dev)
        return out


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (DP) dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """16 x 16 = 256 entries ``("data", "model")``; 2 x 16 x 16 = 512 with a
    ``"pod"`` axis.  With ``devices=None`` an :class:`AbstractMesh`;
    otherwise a :class:`DecodeMesh` over that many entries of ``devices``
    (which may repeat a device)."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        return AbstractMesh(axes, sizes)
    return DecodeMesh(devices, axes, sizes)


def _devices(devices, n: int | None) -> list:
    """``devices`` (default: every visible CUDA device), cut to the first
    ``n``; raises for no card and for more entries than there are."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for a decode mesh; pass "
                "devices=('cpu',) * n for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices) if n is None else int(n)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} entries needs as many devices; "
                         f"{len(devices)} given")
    return devices[:n]


def make_decode_mesh(n_shards: int | None = None, *, devices=None):
    """1-D decode mesh ``("shard",)`` over ``n_shards`` entries of
    ``devices`` (default: all of them; ``devices`` defaults to every
    visible CUDA device).  The sharded executor splits walk rows over the
    product of the mesh axes, so one axis is the no-assumptions default."""
    devs = _devices(devices, n_shards)
    return DecodeMesh(devs, ("shard",), (len(devs),))


def make_smoke_mesh(n_devices: int | None = None, model: int = 2, *,
                    devices=None):
    """A 2-axis ``("data", "model")`` mesh of ``n_devices`` entries of
    ``devices`` (the defaults as :func:`make_decode_mesh`'s), ``model``
    along the second axis."""
    devs = _devices(devices, n_devices)
    if len(devs) % model:
        raise ValueError(f"{len(devs)} devices do not split into "
                         f"model={model} columns")
    return DecodeMesh(devs, ("data", "model"), (len(devs) // model, model))


def make_pod_mesh(n_pods: int | None = None, *, devices=None):
    """1-D ``("pod",)`` mesh of ``n_pods`` entries of ``devices`` (the
    defaults as :func:`make_decode_mesh`'s): one device a pod, for the
    cross-pod compressed train step
    (``repro_torch.runtime.train.make_compressed_crosspod_step``)."""
    devs = _devices(devices, n_pods)
    return DecodeMesh(devs, ("pod",), (len(devs),))
