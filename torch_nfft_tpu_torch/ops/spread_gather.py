"""The spread and the gather without a plan: the scatter and the one-hot
matmul engines.

Counterpart of the JAX package's ``ops/spread_gather.py``. The binned
engine (ops/binned.py) needs a plan; these two read the positions
directly, and the entry points run them where the JAX package does: with
``strategy="scatter"`` or ``"matmul"``, and under ``"auto"`` for small
problems (:func:`plan_or_engine`).

* ``"scatter"``: every point's (2m+2)^dim window weights and flat grid
  indices (:func:`window_weights_and_indices`), the spread an
  ``index_add_`` over chunks of points, the gather an index gather and a
  weighted sum;
* ``"matmul"``: one dense one-hot window matrix per axis, (n, M) (the
  batch folded into axis 0's, (n, batch_size*M)), and the spread and the
  gather as ``torch.matmul`` products with them. It wins for small grids.

Both are plain PyTorch, so autograd differentiates them in the values and,
through the window weights, in the positions, as ``jax.grad`` does the JAX
package's (which has no custom VJP there). Grids are the port's layout,
(batch_size, C, M, ..., M); the JAX functions take and return the flat
(batch_size * M^dim, C).
"""

from __future__ import annotations

import torch

from .window import DEFAULT_SIGMA, DEFAULT_WINDOW, compute_psi, compute_shifts, \
    window_index_offsets

__all__ = ["spread", "gather", "window_weights_and_indices", "plan_or_engine"]

# the JAX package's "auto" rule (ops/nfft.py:_maybe_build_plan): plan only
# from this many points on, and only where the one-hot operands would
# exceed ONEHOT_MAX entries; below ONEHOT_MAX "auto" runs the matmul engine
AUTO_PLAN_MIN_POINTS = 4096
ONEHOT_MAX = 1 << 24


def window_weights_and_indices(pos: torch.Tensor, batch: torch.Tensor, N: int, m: int,
                               sigma: float = DEFAULT_SIGMA,
                               window: str = DEFAULT_WINDOW):
    """(flat index, weight) of every point's window cells, each (n, W),
    W = (2m+2)^dim: the index into the flattened (batch_size, M^dim) grid
    with the periodic wrap (shift + l) mod M per axis, the weight
    prod_d psi[i, d, l_d] (differentiable in ``pos``)."""
    n, dim = pos.shape
    M = int(round(sigma * N))
    shifts = compute_shifts(pos, N, m, sigma)
    psi = compute_psi(pos, shifts, N, m, sigma, window)  # (n, dim, L)
    ls = window_index_offsets(dim, m, device=pos.device).long()  # (W, dim)
    idx = (shifts.long()[:, None, :] + ls[None]) % M  # (n, W, dim)
    flat = idx[..., 0]
    for d in range(1, dim):
        flat = flat * M + idx[..., d]
    flat = batch.long()[:, None] * M**dim + flat
    weights = psi[:, 0, :][:, ls[:, 0]]
    for d in range(1, dim):
        weights = weights * psi[:, d, :][:, ls[:, d]]
    return flat, weights


def _auto_chunk(n: int, W: int, C: int, itemsize: int, budget_bytes: int = 1 << 29) -> int:
    """Points per chunk keeping the (chunk, W, C) temporary under budget;
    at least 1, also for n = 0 (a step of range())."""
    return max(1, min(n, budget_bytes // max(1, W * C * itemsize)))


def _to_grid(g_flat: torch.Tensor, batch_size: int, dim: int, M: int) -> torch.Tensor:
    """(batch_size * M^dim, C) -> (batch_size, C, M^dim), contiguous."""
    C = g_flat.shape[1]
    return g_flat.reshape((batch_size,) + (M,) * dim + (C,)).movedim(-1, 1).contiguous()


def _from_grid(g: torch.Tensor) -> torch.Tensor:
    """(batch_size, C, M^dim) -> (batch_size * M^dim, C)."""
    return g.movedim(1, -1).reshape(-1, g.shape[1])


# ---------------------------------------------------------------------------
# Scatter engine
# ---------------------------------------------------------------------------


def _spread_scatter(x, pos, batch, batch_size, N, m, sigma, point_chunk, window):
    n, dim = pos.shape
    C = x.shape[1]
    M = int(round(sigma * N))
    W = (2 * m + 2) ** dim
    if point_chunk is None:
        point_chunk = _auto_chunk(n, W, C, x.element_size())
    g = x.new_zeros((batch_size * M**dim, C))
    for c0 in range(0, n, point_chunk):
        c1 = min(n, c0 + point_chunk)
        flat, weights = window_weights_and_indices(pos[c0:c1], batch[c0:c1], N, m, sigma,
                                                   window)
        vals = x[c0:c1, None, :] * weights[..., None]
        g.index_add_(0, flat.reshape(-1), vals.reshape(-1, C))
    return g


def _gather_scatter(g_flat, pos, batch, N, m, sigma, point_chunk, window):
    n, dim = pos.shape
    C = g_flat.shape[1]
    W = (2 * m + 2) ** dim
    if n == 0:
        return g_flat.new_zeros((0, C))
    if point_chunk is None:
        point_chunk = _auto_chunk(n, W, C, g_flat.element_size())
    out = []
    for c0 in range(0, n, point_chunk):
        c1 = min(n, c0 + point_chunk)
        flat, weights = window_weights_and_indices(pos[c0:c1], batch[c0:c1], N, m, sigma,
                                                   window)
        vals = g_flat[flat]  # (chunk, W, C)
        out.append(torch.einsum("nw,nwc->nc", weights, vals))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# One-hot matmul engine
# ---------------------------------------------------------------------------


def _onehot_rows(pos, batch, batch_size, N, m, sigma, window):
    """One dense window matrix per axis: (n, M), axis 0's (n, batch_size*M)
    with the batch folded into its columns; row i holds point i's window
    values at its (wrapped) cells."""
    n, dim = pos.shape
    M = int(round(sigma * N))
    shifts = compute_shifts(pos, N, m, sigma)
    psi = compute_psi(pos, shifts, N, m, sigma, window)  # (n, dim, L)
    L = 2 * m + 2
    ar = torch.arange(L, device=pos.device)
    mats = []
    for d in range(dim):
        cols = (shifts[:, d:d + 1].long() + ar) % M  # (n, L)
        width = M
        if d == 0 and batch_size > 1:
            cols = batch.long()[:, None] * M + cols
            width = batch_size * M
        mats.append(psi.new_zeros((n, width)).scatter_add(1, cols, psi[:, d, :]))
    return mats


def _spread_matmul(x, pos, batch, batch_size, N, m, sigma, window):
    n, dim = pos.shape
    C = x.shape[1]
    M = int(round(sigma * N))
    if n == 0:
        return x.new_zeros((batch_size * M**dim, C))
    mats = _onehot_rows(pos, batch, batch_size, N, m, sigma, window)
    rhs = x  # rhs[j, (u_1, ..., u_{dim-1}, c)] = prod_d S_d[j, u_d] x[j, c]
    for d in range(dim - 1, 0, -1):
        rhs = (mats[d][:, :, None] * rhs.reshape(n, 1, -1)).reshape(n, -1)
    g = torch.matmul(mats[0].T, rhs)  # (batch_size * M, M^(dim-1) * C)
    return g.reshape(batch_size * M**dim, C)


def _gather_matmul(g_flat, pos, batch, batch_size, N, m, sigma, window):
    n, dim = pos.shape
    C = g_flat.shape[1]
    M = int(round(sigma * N))
    if n == 0:
        return g_flat.new_zeros((0, C))
    mats = _onehot_rows(pos, batch, batch_size, N, m, sigma, window)
    t = torch.matmul(mats[0], g_flat.reshape(batch_size * M, -1))  # (n, M^(dim-1) C)
    for d in range(1, dim):
        t = torch.einsum("nu,nuc->nc", mats[d], t.reshape(n, M, -1))
    return t


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _onehot_cost(n, dim, batch_size, M, C):
    """Entries of the one-hot engine's operands: (n, batch_size*M) plus
    (n, M^(dim-1)*C)."""
    return n * batch_size * M + n * (M ** max(0, dim - 1)) * C


def _pick_strategy(strategy, n, dim, batch_size, M, C):
    if strategy != "auto":
        return strategy
    return "matmul" if _onehot_cost(n, dim, batch_size, M, C) <= ONEHOT_MAX else "scatter"


def plan_or_engine(strategy: str, n: int, dim: int, batch_size: int, M: int, C: int) -> str:
    """``"binned"`` where a call without a plan runs the binned engine (and
    plans), else the engine it runs: the JAX package's ``_maybe_build_plan``
    and ``_pick_strategy``. ``"auto"`` plans from AUTO_PLAN_MIN_POINTS
    points on where the one-hot operands exceed ONEHOT_MAX entries, and
    otherwise takes the matmul engine up to ONEHOT_MAX, the scatter engine
    beyond; the explicit strategies are taken as given."""
    if strategy == "auto" and (n < AUTO_PLAN_MIN_POINTS
                               or _onehot_cost(n, dim, batch_size, M, C) <= ONEHOT_MAX):
        return _pick_strategy(strategy, n, dim, batch_size, M, C)
    return "binned" if strategy == "auto" else strategy


def _split_complex(fn, v):
    """fn on a complex array's real and imaginary planes (the engines'
    weights are real)."""
    if v.is_complex():
        return torch.complex(fn(v.real.contiguous()), fn(v.imag.contiguous()))
    return fn(v)


def _batch_vector(batch, n, device):
    if batch is None:
        return torch.zeros(n, dtype=torch.int32, device=device)
    return torch.as_tensor(batch, device=device)


def spread(x: torch.Tensor, pos: torch.Tensor, batch, batch_size: int, N: int, m: int,
           sigma: float = DEFAULT_SIGMA, strategy: str = "auto", point_chunk=None,
           window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """Window-convolve x (n, C) at ``pos`` (n, dim) onto the oversampled
    grid, (batch_size, C, M^dim), by the scatter or the matmul engine
    (``"auto"``: :func:`_pick_strategy`)."""
    n, dim = pos.shape
    M = int(round(sigma * N))
    batch = _batch_vector(batch, n, pos.device)
    strat = _pick_strategy(strategy, n, dim, batch_size, M, x.shape[1])
    if strat == "matmul":
        g = _split_complex(
            lambda v: _spread_matmul(v, pos, batch, batch_size, N, m, sigma, window), x)
    elif strat == "scatter":
        g = _split_complex(lambda v: _spread_scatter(v, pos, batch, batch_size, N, m, sigma,
                                                     point_chunk, window), x)
    else:
        raise ValueError(f"strategy {strategy!r}: the plan-free engines are 'scatter' "
                         "and 'matmul'")
    return _to_grid(g, batch_size, dim, M)


def gather(g: torch.Tensor, pos: torch.Tensor, batch, batch_size: int, N: int, m: int,
           sigma: float = DEFAULT_SIGMA, strategy: str = "auto", point_chunk=None,
           window: str = DEFAULT_WINDOW) -> torch.Tensor:
    """Interpolate the grid g (batch_size, C, M^dim) back to the points,
    (n, C): the transpose of :func:`spread`."""
    n, dim = pos.shape
    M = int(round(sigma * N))
    batch = _batch_vector(batch, n, pos.device)
    g_flat = _from_grid(g)
    strat = _pick_strategy(strategy, n, dim, batch_size, M, g_flat.shape[1])
    if strat == "matmul":
        return _split_complex(
            lambda v: _gather_matmul(v, pos, batch, batch_size, N, m, sigma, window), g_flat)
    if strat == "scatter":
        return _split_complex(
            lambda v: _gather_scatter(v, pos, batch, N, m, sigma, point_chunk, window), g_flat)
    raise ValueError(f"strategy {strategy!r}: the plan-free engines are 'scatter' and 'matmul'")
