"""Point-cloud preprocessing: centers, radii, shifting and scaling.

Counterpart of the JAX package's ``utils/points.py``. Batched reductions
are ``scatter_reduce`` over the batch vector; without ``num_segments`` the
batch count is ``batch[-1] + 1`` (the vector is sorted). As in the JAX
package, the center of an empty batch is NaN and its radius -inf; no point
reads them. Points are float32. Each function runs on the CUDA card unless
``device="cpu"`` is given, and is differentiable in the points.
"""

from __future__ import annotations

import torch

from .._device import resolve_device

__all__ = [
    "compute_points_center",
    "shift_points_by_center",
    "compute_points_radius",
    "scale_points_by_norm",
]


def _points(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, device=dev).to(torch.float32)


def _num_segments(batch, num_segments) -> int:
    if num_segments is not None:
        return int(num_segments)
    return int(torch.as_tensor(batch)[-1]) + 1


def _segment(values: torch.Tensor, batch, ns: int, reduce: str) -> torch.Tensor:
    """Per-batch min ("amin") or max ("amax") of the rows of ``values``."""
    fill = float("inf") if reduce == "amin" else float("-inf")
    out = values.new_full((ns,) + tuple(values.shape[1:]), fill)
    idx = torch.as_tensor(batch, device=values.device).long()
    idx = idx.reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, reduce, include_self=True)


def compute_points_center(sources, targets=None, source_batch=None, target_batch=None,
                          /, batch=None, *, num_segments=None, device=None) -> torch.Tensor:
    """Center of the bounding box of the point set(s): (dim,), or
    (batch_size, dim) when batched."""
    dev = resolve_device(device)
    sources = _points(sources, dev)
    if batch is not None:
        source_batch = target_batch = batch
    if source_batch is None:
        min_c, max_c = sources.amin(0), sources.amax(0)
        if targets is not None:
            targets = _points(targets, dev)
            min_c = torch.minimum(min_c, targets.amin(0))
            max_c = torch.maximum(max_c, targets.amax(0))
    else:
        ns = _num_segments(source_batch, num_segments)
        min_c = _segment(sources, source_batch, ns, "amin")
        max_c = _segment(sources, source_batch, ns, "amax")
        if targets is not None:
            targets = _points(targets, dev)
            min_c = torch.minimum(min_c, _segment(targets, target_batch, ns, "amin"))
            max_c = torch.maximum(max_c, _segment(targets, target_batch, ns, "amax"))
    return 0.5 * (min_c + max_c)


def _per_point(v: torch.Tensor, batch) -> torch.Tensor:
    """A per-batch value gathered to the points of ``batch``."""
    return v[torch.as_tensor(batch, device=v.device).long()]


def shift_points_by_center(sources, targets=None, source_batch=None, target_batch=None,
                           /, batch=None, *, num_segments=None, device=None):
    """(sources, targets) translated so the bounding-box center of each
    point set is the origin; targets stays None when not given."""
    dev = resolve_device(device)
    sources = _points(sources, dev)
    if batch is not None:
        source_batch = target_batch = batch
    center = compute_points_center(sources, targets, source_batch, target_batch,
                                   num_segments=num_segments, device=dev)
    sources = sources - (center if source_batch is None else _per_point(center, source_batch))
    if targets is not None:
        targets = _points(targets, dev) - (
            center if target_batch is None else _per_point(center, target_batch))
    return sources, targets


def compute_points_radius(sources, targets=None, source_batch=None, target_batch=None,
                          /, batch=None, norm="euclidean", *, num_segments=None,
                          device=None) -> torch.Tensor:
    """Largest point norm ("euclidean" or "infinity") of the point set(s):
    a scalar, or (batch_size,) when batched."""
    dev = resolve_device(device)
    sources = _points(sources, dev)
    if batch is not None:
        source_batch = target_batch = batch
    if norm == "euclidean":
        def point_norm(p):
            return torch.sqrt(torch.sum(p**2, dim=1))
    elif norm == "infinity":
        def point_norm(p):
            return p.abs().amax(1)
    else:
        raise ValueError(f"compute_points_radius received unknown norm: {norm}")
    if source_batch is None:
        radius = point_norm(sources).amax()
        if targets is not None:
            radius = torch.maximum(radius, point_norm(_points(targets, dev)).amax())
    else:
        ns = _num_segments(source_batch, num_segments)
        radius = _segment(point_norm(sources), source_batch, ns, "amax")
        if targets is not None:
            radius = torch.maximum(
                radius, _segment(point_norm(_points(targets, dev)), target_batch, ns, "amax"))
    return radius


def scale_points_by_norm(sources, targets=None, source_batch=None, target_batch=None,
                         /, batch=None, factor=1, norm="euclidean", *, num_segments=None,
                         device=None):
    """(sources, targets) scaled so the largest norm of each point set is
    ``factor``; targets stays None when not given."""
    dev = resolve_device(device)
    sources = _points(sources, dev)
    if batch is not None:
        source_batch = target_batch = batch
    radius = compute_points_radius(sources, targets, source_batch, target_batch, norm=norm,
                                   num_segments=num_segments, device=dev)
    scale = factor / radius
    sources = sources * (scale if source_batch is None
                         else _per_point(scale, source_batch)[:, None])
    if targets is not None:
        targets = _points(targets, dev) * (
            scale if target_batch is None else _per_point(scale, target_batch)[:, None])
    return sources, targets
