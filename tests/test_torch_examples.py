"""The application demos of the PyTorch port (examples_torch/) on the CPU at
small sizes, each with its own assertion (the assertion of its JAX
counterpart in examples/): the RBF fit's held-out RMSE under a quarter of
the baseline, the graph smoothing's separation above 3x the raw signal's,
the learned kernel's held-out operator error under 3e-2; and the RBF and
graph demos' operators, from their data (``problem``), against the JAX
package's kernels on the same points. The multi-rank demos are in
tests/test_torch_examples_dist.py.
"""

import numpy as np
import pytest
import torch

import torch_nfft_tpu as tn
from examples_torch import graph_smoothing, learn_kernel, rbf_interpolation


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_rbf_interpolation_beats_the_baseline():
    out = rbf_interpolation.main(n_train=3000, n_test=500, device="cpu")
    assert out["rmse"] < 0.25 * out["baseline"]


def test_graph_smoothing_separates_the_clusters():
    out = graph_smoothing.main(n=3000, device="cpu")
    assert out["smoothed"] > 3 * out["raw"]


def test_rbf_operators_match_the_jax_package():
    """The demo's Matern Gram operator and its prediction operator (train ->
    test) at 3000 + 500 points: one matvec each against the JAX package's
    MaternKernel of the same parameters on the same points."""
    kernel, train, test, _, _ = rbf_interpolation.problem(3000, 500, device="cpu")
    pts = torch.cat([train, test]).numpy()
    radius = float(np.abs(pts - pts.mean(0)).max()) * 1.01
    wp = tn.suggest_window_parameters(1e-4)
    jk = tn.MaternKernel(0.35, nu=1.5, dim=2, bandwidth=64, cutoff=wp["m"],
                         max_infinity_norm=radius, window=wp["window"])
    v = np.random.default_rng(5).standard_normal(3000).astype(np.float32)
    tr, te = train.numpy(), test.numpy()
    assert _rel((kernel(train) @ torch.from_numpy(v)).numpy(), jk(tr) @ v) < 1e-5
    assert _rel((kernel.gram_matrix(train, test) @ torch.from_numpy(v)).numpy(),
                jk.gram_matrix(tr, te) @ v) < 1e-5


def test_graph_adjacency_matches_the_jax_package():
    """The demo's ``sym`` adjacency operator at 3000 points against the JAX
    package's on the same points."""
    adj, pos, signal, _ = graph_smoothing.problem(3000, device="cpu")
    jadj = tn.GaussianKernel(sigma=0.35, dim=2, bandwidth=32, cutoff=4,
                             max_euclidean_norm=1.5).adjacency_matrix(pos, normalization="sym")
    assert _rel((adj @ torch.from_numpy(signal)).numpy(), jadj @ signal) < 1e-5


def test_learn_kernel_recovers_the_operator():
    """At the JAX demo's defaults (n = 2000, 200 Adam steps); the JAX demo
    reads the same errors, 2.585e-02 and 4.590e-02, on the CPU."""
    out = learn_kernel.main(device="cpu")
    assert out["op_err"] < 3e-2
    assert out["final_loss"] < 1e-2 * out["first_loss"]


@pytest.mark.parametrize("demo", [rbf_interpolation, graph_smoothing, learn_kernel])
def test_demos_raise_without_a_card(monkeypatch, demo):
    """Without a card and without device='cpu' a demo raises; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main()
