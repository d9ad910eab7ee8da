"""Utilities of the PyTorch port: point preprocessing."""

from .points import (
    compute_points_center,
    compute_points_radius,
    scale_points_by_norm,
    shift_points_by_center,
)

__all__ = [
    "compute_points_center",
    "compute_points_radius",
    "shift_points_by_center",
    "scale_points_by_norm",
]
