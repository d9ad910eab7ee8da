"""PyTorch port vs JAX package: the kernel-coefficient generators and the
interpolation grids (the cases of tests/test_coeffs.py).

Both packages compute in float32 (the boundary polynomial's solve in
float64 NumPy); they agree to 1e-5 of the output's largest entry, the
ground rule between the packages. The JAX tests' own bars hold the port's
coefficients to the analytic ones and to the boundary conditions.
"""

import _torch_port  # noqa: F401  (warms up the CPU math functions)
import numpy as np
import pytest
import torch

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops.coeffs import _boundary_polynomial as jax_boundary_polynomial
from torch_nfft_tpu_torch.ops.coeffs import _boundary_polynomial

REL = 1e-5


def assert_close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max())


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_analytic_coeffs_match_jax(dim):
    sigma, N = 0.25, 8
    c = tp.gaussian_analytic_coeffs(sigma, dim=dim, N=N, device="cpu")
    assert c.dtype == torch.float32 and tuple(c.shape) == (N,) * dim
    assert_close(c.numpy(), tn.gaussian_analytic_coeffs(sigma, dim=dim, N=N))
    if dim == 1:
        l = np.arange(N) - N // 2
        expected = np.sqrt(np.pi) * sigma * np.exp(-(sigma**2) * np.pi**2 * l**2)
        np.testing.assert_allclose(c.numpy(), expected, rtol=1e-6)


def test_analytic_coeffs_separable():
    c1 = tp.gaussian_analytic_coeffs(0.3, dim=1, N=8, device="cpu").numpy()
    c2 = tp.gaussian_analytic_coeffs(0.3, dim=2, N=8, device="cpu").numpy()
    np.testing.assert_allclose(c2, np.outer(c1, c1), rtol=1e-6)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_interpolation_grids_match_jax(dim):
    N = 8
    g = tp.interpolation_grid(dim=dim, N=N, device="cpu").numpy()
    assert g.shape == (N,) * dim + (dim,)
    np.testing.assert_array_equal(g, np.asarray(tn.interpolation_grid(dim=dim, N=N)))
    r = tp.radial_interpolation_grid(dim=dim, N=N, device="cpu").numpy()
    assert_close(r, tn.radial_interpolation_grid(dim=dim, N=N))
    np.testing.assert_allclose(r, np.linalg.norm(g, axis=-1), rtol=1e-5, atol=1e-7)


def test_interpolation_grid_layout():
    N = 8
    g = tp.interpolation_grid(dim=2, N=N, device="cpu").numpy()
    np.testing.assert_allclose(g[3, 5], [3 / N - 0.5, 5 / N - 0.5], rtol=1e-6)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_interpolated_kernel_coeffs_match_jax(dim):
    """The user-defined kernel workflow against JAX and against the
    built-in Gaussian path."""
    sigma, N = 0.2, 8
    r = tp.radial_interpolation_grid(dim=dim, N=N, device="cpu")
    user = tp.interpolated_kernel_coeffs(torch.exp(-(r**2) / sigma**2), device="cpu")
    assert user.dtype == torch.complex64
    rj = np.asarray(tn.radial_interpolation_grid(dim=dim, N=N))
    assert_close(user.numpy(), tn.interpolated_kernel_coeffs(np.exp(-(rj**2) / sigma**2)))
    builtin = tp.gaussian_interpolated_coeffs(sigma, dim=dim, N=N, p=-1, device="cpu")
    np.testing.assert_allclose(user.numpy(), builtin.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("p,eps", [(-1, 0.0), (2, 0.125), (0, 0.2)])
def test_gaussian_interpolated_coeffs_match_jax(dim, p, eps):
    sigma, N = 0.45, 8
    got = tp.gaussian_interpolated_coeffs(sigma, dim=dim, N=N, p=p, eps=eps, device="cpu")
    assert got.dtype == torch.complex64
    assert_close(got.numpy(), tn.gaussian_interpolated_coeffs(sigma, dim=dim, N=N, p=p,
                                                              eps=eps))


def test_interpolated_converges_to_analytic():
    ci = tp.gaussian_interpolated_coeffs(0.1, dim=1, N=32, device="cpu").numpy().real
    ca = tp.gaussian_analytic_coeffs(0.1, dim=1, N=32, device="cpu").numpy()
    assert np.abs(ci - ca).max() / np.abs(ca).max() < 1e-3


def test_interpolated_coeffs_imag_small():
    c = tp.gaussian_interpolated_coeffs(0.2, dim=2, N=16, p=-1, device="cpu").numpy()
    assert np.abs(c.imag).max() < 1e-4 * np.abs(c.real).max()


def test_boundary_polynomial_matches_jax_and_its_conditions():
    sigma2, eps, p = 0.04, 0.125, 3
    coefs = _boundary_polynomial(sigma2, eps, p)
    np.testing.assert_allclose(coefs, jax_boundary_polynomial(sigma2, eps, p), rtol=1e-12)
    poly = np.polynomial.polynomial.Polynomial(coefs)
    a = 0.5 - eps
    K = lambda r: np.exp(-(r**2) / sigma2)  # noqa: E731
    assert abs(poly(a) - K(a)) < 1e-10
    assert abs(poly.deriv(1)(a) - (-2 * a / sigma2) * K(a)) < 1e-8
    assert abs(poly.deriv(1)(0.5)) < 1e-8
    assert abs(poly.deriv(2)(0.5)) < 1e-6


def test_regularized_coeffs_improve_wide_gaussian():
    sigma, N = 0.45, 32
    plain = tp.gaussian_interpolated_coeffs(sigma, dim=1, N=N, p=-1, device="cpu").numpy()
    reg = tp.gaussian_interpolated_coeffs(sigma, dim=1, N=N, p=2, eps=0.125,
                                          device="cpu").numpy()
    assert np.abs(reg[:4]).max() < np.abs(plain[:4]).max()


def test_regularized_requires_eps():
    with pytest.raises(ValueError):
        tp.gaussian_interpolated_coeffs(0.3, dim=1, N=16, p=2, eps=0.0, device="cpu")
