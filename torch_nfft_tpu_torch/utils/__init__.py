"""Utilities of the PyTorch port: point preprocessing, the Lanczos
eigensolver and the accuracy self-check."""

from .diagnostics import accuracy_check
from .points import (
    compute_points_center,
    compute_points_radius,
    scale_points_by_norm,
    shift_points_by_center,
)
from .solve import eigsh_operator, lanczos

__all__ = [
    "accuracy_check",
    "compute_points_center",
    "compute_points_radius",
    "eigsh_operator",
    "lanczos",
    "shift_points_by_center",
    "scale_points_by_norm",
]
