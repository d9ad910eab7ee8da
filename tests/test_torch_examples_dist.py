"""The multi-rank demos of the PyTorch port (examples_torch/) on gloo ranks
of the CPU, each with its own assertion (that of its JAX counterpart in
examples/): the sharded training's final loss under 0.05 times the first
on a data 2 x points 2 mesh of four ranks, and the grid-sharded adjoint at
N = 32, n = 2^12 within 1e-3 of the float64 sum at 32 sampled frequencies,
on two slabs and on one. The ranks import neither JAX nor the JAX package;
the training's losses are held against the JAX package's train step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples_torch import grid_sharded_large, multichip_training
from torch_nfft_tpu import gaussian_analytic_coeffs
from torch_nfft_tpu import parallel as jpar


def _jax_losses(world: int, steps: int) -> list:
    """The JAX package's train step (``make_fastsum_train_step`` with
    ``optax.adam(0.02)``) on the demo's inputs, on a data 2 x points
    world/2 mesh of the virtual CPU devices: the loss of every step."""
    B, n, dim, N, m, C = (multichip_training.B, multichip_training.n, multichip_training.dim,
                          multichip_training.N, multichip_training.m, multichip_training.C)
    rng = np.random.default_rng(0)
    pos = (rng.random((B, n, dim)) - 0.5).astype(np.float32) / 4
    y = np.sin(6 * pos[..., :1].sum(-1, keepdims=True)).astype(np.float32)
    mesh = jpar.make_mesh({"data": 2, "points": world // 2}, devices=jax.devices()[:world])
    opt = optax.adam(0.02)
    step, sh = jpar.make_fastsum_train_step(
        mesh, gaussian_analytic_coeffs(0.3, dim=dim, N=N), batch_size=B, n_per_set=n,
        cutoff=m, optimizer=opt)
    w = jax.device_put(jnp.zeros((B, n, C), jnp.float32), sh[0])
    pos_d, y_d = jax.device_put(jnp.asarray(pos), sh[1]), jax.device_put(jnp.asarray(y), sh[2])
    state = opt.init(w)
    losses = []
    for _ in range(steps):
        w, loss, state = step(w, pos_d, y_d, state)
        losses.append(float(loss))
    return losses


def test_multichip_training_on_four_gloo_ranks():
    """The JAX demo's defaults (B = 4 sets of 512 points, 80 Adam steps) on
    a data 2 x points 2 mesh against the JAX package's train step on the
    same inputs and mesh: the first 9 losses within rtol 1e-4, the bar of
    ``tests/test_torch_parallel.py``'s 9 Adam steps, and all 80 within
    1e-3, since float32 rounding differences compound over the steps
    (1.9e-4 at most, measured on the CPU)."""
    out = multichip_training.main(world=4, device="cpu")
    assert out["backend"] == "gloo"
    assert len(out["losses"]) == 80
    assert out["final"] < 0.05 * out["first"]
    ref = _jax_losses(4, 80)
    np.testing.assert_allclose(out["losses"][:9], ref[:9], rtol=1e-4)
    np.testing.assert_allclose(out["losses"], ref, rtol=1e-3)


@pytest.mark.parametrize("world", [1, 2])
def test_grid_sharded_large_small_on_gloo(world):
    out = grid_sharded_large.main(N=32, logn=12, world=world, device="cpu")
    assert out["rel"] < 1e-3
    assert out["peak"] is None and out["T"] == 16


def test_multi_rank_demos_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip_training.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grid_sharded_large.main()
