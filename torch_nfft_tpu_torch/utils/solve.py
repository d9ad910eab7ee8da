"""A Lanczos eigensolver for the symmetric matrix-free operators.

Counterpart of the JAX package's ``utils/solve.py`` (conjugate gradients
live on ``GramMatrix.solve``): :func:`lanczos` tridiagonalises a symmetric
matvec, :func:`eigsh_operator` takes the top eigenpairs of a
``GramMatrix`` or an ``AdjacencyMatrix`` ("sym"/"none" normalisation, e.g.
the spectral embedding of a point cloud's graph). Where the operator has
``apply_slot`` and plans, every matvec runs in the plan's slot layout: the
point-order permutations are paid once a solve, not once a step.
"""

from __future__ import annotations

import torch

__all__ = ["lanczos", "eigsh_operator"]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def lanczos(matvec, v0, num_iters: int, *, reorthogonalize: bool = True,
            breakdown_tol: float = 1e-5):
    """Lanczos tridiagonalisation of a symmetric ``matvec`` from ``v0`` (any
    shape, taken as a flat vector). Returns ``(alphas, betas, V)``: the
    tridiagonal's diagonal (k,) and off-diagonal (k-1,), and the Krylov
    basis stacked on axis 0, (k, *v0.shape).

    With ``reorthogonalize`` (the default) each new direction is
    orthogonalised against the basis by classical Gram-Schmidt applied
    twice. Breakdown: once beta falls to ``breakdown_tol`` times the scale
    (the largest |alpha| so far and the first beta, never a later beta:
    recycled noise must not raise its own cutoff) the recurrence stops, its
    betas and basis rows staying exactly zero. The JAX package's rule and
    arithmetic; a Python loop over a preallocated basis replaces its
    ``lax.scan``."""
    v0 = torch.as_tensor(v0)
    k = int(num_iters)
    V = v0.new_zeros((k,) + tuple(v0.shape))
    v = v0 / torch.sqrt(_dot(v0, v0))
    zero = v0.new_zeros(())
    beta_prev, scale = zero, zero
    alphas, betas = [], []
    flat = V.reshape(k, -1)
    for i in range(k):
        w = matvec(v)
        alpha = _dot(v, w).to(v.dtype)
        w = w - alpha * v - beta_prev * V[max(i - 1, 0)]
        if reorthogonalize and i > 0:
            for _ in range(2):  # one pass over a basis gone non-orthogonal amplifies w
                coef = flat[:i] @ w.reshape(-1)
                w = w - (coef @ flat[:i]).reshape(w.shape)
        beta = torch.sqrt(_dot(w, w)).to(v.dtype)
        scale = torch.maximum(scale, alpha.abs())
        if i == 0:
            scale = torch.maximum(scale, beta)
        alive = beta > breakdown_tol * scale
        beta = torch.where(alive, beta, zero)
        V[i] = v
        v = torch.where(alive, w / torch.where(alive, beta, zero + 1), zero)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1], V


def eigsh_operator(op, num_eigs: int, *, num_iters: int | None = None, seed: int = 0,
                   use_slot: bool = True):
    """The top ``num_eigs`` eigenpairs of a symmetric matrix-free operator
    (``GramMatrix``, ``AdjacencyMatrix``) by :func:`lanczos` and a dense
    ``torch.linalg.eigh`` of the tridiagonal: ``(eigenvalues, eigenvectors)``,
    ascending, (num_eigs,) and (n, num_eigs), on the operator's device.

    The operator's plans are built first. With ``use_slot`` (the default)
    and an operator with ``apply_slot``, every matvec runs in slot layout
    and the Ritz vectors return to user order through ``from_slot``;
    otherwise ``op @ v``. One matvec runs before the iteration, to fill the
    operator's caches. The start vector is normal noise from
    ``torch.Generator(device).manual_seed(seed)``: not the JAX package's
    (its PRNG is JAX's own), so the two solvers start apart and meet in
    the converged eigenvalues; pass the same ``v0`` to :func:`lanczos` to
    run both on one start."""
    if not op.is_symmetric():
        raise ValueError("eigsh_operator requires a symmetric operator")
    n = op.shape[1]
    k = int(num_iters) if num_iters is not None else max(2 * num_eigs + 10, 20)
    gram = getattr(op, "gram_matrix", op)
    plans_ok = False
    if hasattr(gram, "_plans"):
        try:
            plans_ok = gram._plans(require=True)[0] is not None
        except ValueError:
            plans_ok = False
    slot = use_slot and plans_ok and hasattr(op, "apply_slot")
    dev = torch.device(op.device)
    gen = torch.Generator(dev).manual_seed(int(seed))
    if slot:
        v0 = gram.to_slot(torch.randn(n, generator=gen, device=dev))
        mv = op.apply_slot
    else:
        v0 = torch.randn((n, 1), generator=gen, device=dev)

        def mv(v):
            return op @ v
    mv(v0)
    alphas, betas, V = lanczos(mv, v0, k)
    tri = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
    evals, evecs = torch.linalg.eigh(tri)  # ascending
    w = evals[k - num_eigs:]
    y = torch.tensordot(evecs[:, k - num_eigs:], V, dims=([0], [0]))  # (num_eigs, *vshape)
    if slot:
        y = torch.stack([gram.from_slot(yi)[:, 0] for yi in y], dim=1)
    else:
        y = y[..., 0].movedim(0, -1)
    return w, y
