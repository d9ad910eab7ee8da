"""Mesh construction and point-padding helpers.

Counterpart of the JAX package's ``parallel/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes over the
ranks of the default process group, which the caller initialises
(``torch.distributed.init_process_group``, one process per rank). A named
axis is ``mesh.get_group(name)``; a rank's place on it
``mesh.get_local_rank(name)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._device import resolve_device

__all__ = ["make_mesh", "pad_points", "axis_group", "mesh_device"]


def make_mesh(axes: dict[str, int] | None = None, device_type: str | None = None) -> DeviceMesh:
    """A named mesh over every rank of the default process group.

    ``axes`` maps axis name -> size; the product must equal the world size.
    A value of ``-1`` (at most one) absorbs the remaining ranks. With no
    arguments, all ranks land on a single ``"points"`` axis.
    ``device_type`` None means ``"cuda"`` (raises without a card); pass
    ``"cpu"`` for a mesh of host ranks (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group)")
    dev = resolve_device(device_type)
    n = dist.get_world_size()
    if axes is None:
        axes = {"points": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by fixed axes {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} != {n} devices")
    return init_device_mesh(dev.type, tuple(sizes), mesh_dim_names=tuple(names))


def axis_group(mesh: DeviceMesh, name: str | None):
    """The process group of mesh axis ``name``; None for no axis."""
    return None if name is None else mesh.get_group(name)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: the current card, or the CPU."""
    return resolve_device(mesh.device_type)


def pad_points(pos, x=None, batch=None, *, multiple: int):
    """Pad a point set so that n divides ``multiple`` (the points axis).

    The sharded transforms require equal local shards. Padding appends
    zero-weight points at the origin of the LAST batch: spreading a zero
    adds nothing (adjoint and fastsum are exact), and the padded rows of a
    forward output are sliced away with the returned count. Tensors give
    tensors, anything else numpy.

    Returns (pos, x, batch, n_valid); x/batch stay None if not given."""
    as_tensor = isinstance(pos, torch.Tensor)
    conv = torch.as_tensor if as_tensor else np.asarray
    pos = conv(pos)
    n = pos.shape[0]
    n_pad = (-n) % int(multiple)
    if n_pad == 0:
        return pos, x, batch, n

    def pad(a, fill_last=False):
        a = conv(a)
        if fill_last:
            tail = a[-1:].repeat(n_pad) if as_tensor else np.repeat(a[-1:], n_pad)
        else:
            shape = (n_pad,) + tuple(a.shape[1:])
            tail = a.new_zeros(shape) if as_tensor else np.zeros(shape, a.dtype)
        return torch.cat([a, tail]) if as_tensor else np.concatenate([a, tail])

    return (pad(pos), None if x is None else pad(x),
            None if batch is None else pad(batch, fill_last=True), n)
