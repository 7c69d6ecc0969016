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
the CPU.  The production and data-parallel meshes of the training side
are not part of the decode port.
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
