"""Input validation for debugging, switched on by ``TORCH_NFFT_TPU_DEBUG=1``.

Counterpart of ``debug_enabled`` and ``validate_inputs`` of the JAX
package's ``utils/debug.py``. Malformed inputs give silently wrong output
rather than an error: a NaN position poisons the window products, a
position outside [-1/2, 1/2) lands in the wrong cell, an unsorted batch
vector breaks the ``batch[-1] + 1`` convention (``core_cuda.cu:60``). With
the variable set, ``nfft_adjoint``, ``nfft_forward`` and ``nfft_fastsum``
check their points and batch vectors first. On card tensors the checks run
on the device as one reduction and one synchronisation, paid only under
debug. The JAX package's ``with_checkify`` (index and NaN checks inside
compiled code) has no PyTorch counterpart.
"""

from __future__ import annotations

import os

import torch

__all__ = ["debug_enabled", "validate_inputs"]


def debug_enabled() -> bool:
    return os.environ.get("TORCH_NFFT_TPU_DEBUG", "0") not in ("0", "", "false")


def validate_inputs(pos, batch=None, batch_size=None) -> None:
    """Raise ``ValueError`` on non-finite positions, positions outside
    [-1/2, 1/2], a batch vector of the wrong shape, unsorted, or with ids
    outside [0, batch_size). ``pos`` and ``batch`` are tensors on any device
    or array-likes."""
    p = torch.as_tensor(pos).detach()
    n = p.shape[0]
    stats = [(~torch.isfinite(p)).any(), p.abs().amax() if p.numel() else p.new_zeros(())]
    if batch is not None:
        b = torch.as_tensor(batch, device=p.device).detach()
        if tuple(b.shape) != (n,):
            raise ValueError(f"batch shape {tuple(b.shape)} != (n,) = ({n},)")
        if b.numel():
            stats += [(b[1:] < b[:-1]).any(), b.min(), b.max()]
    # one transfer (one synchronisation on the card) for every check
    s = torch.stack([v.to(torch.float64) for v in stats]).tolist()
    if s[0]:
        raise ValueError("positions contain non-finite values")
    if s[1] > 0.5:
        raise ValueError(
            "positions must lie in [-1/2, 1/2); scale them first "
            "(scale_points_by_norm / GaussianKernel do this automatically)")
    if len(s) > 2:
        if s[2]:
            raise ValueError("batch indices must be sorted ascending")
        lo, hi = int(s[3]), int(s[4])
        if lo < 0 or (batch_size is not None and hi >= batch_size):
            raise ValueError(f"batch indices must lie in [0, {batch_size}); got [{lo}, {hi}]")
