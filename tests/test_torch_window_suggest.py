"""PyTorch port vs JAX package: ``suggest_window_parameters`` and
``set_complex_override``.

At the JAX package's pipeline floor the port's error model and its choice
equal the JAX package's over tolerances x oversampling factors, warnings
included; at the port's own floor (``window.F32_PIPELINE_FLOOR``, measured
on the card) the choice still reaches the tolerance against the dense NDFT
on the CPU. With the complex pipelines switched off both packages run a
real input with a real output through the planar pipeline, agreeing within
rel-L2 1e-5, and raise on complex outputs.
"""

import warnings

import numpy as np
import pytest
import torch
from _torch_port import points, rel_l2

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.ops import nfft as jnfft
from torch_nfft_tpu.ops import window as jwindow
from torch_nfft_tpu_torch.ops import nfft as pnfft
from torch_nfft_tpu_torch.ops import window as pwindow

TOLS = (1e-2, 1e-3, 3e-4, 1e-4, 5e-5, 1e-5, 1e-8)
SIGMAS = (1.25, 1.5, 2.0, 3.0)


def _suggest(fn, tol, sigma):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p = fn(tol, sigma)
    return p, [str(w.message).split(";")[0] for w in caught]


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("tol", TOLS)
def test_same_choice_as_jax_at_its_floor(tol, sigma, monkeypatch):
    monkeypatch.setattr(pwindow, "F32_PIPELINE_FLOOR", jwindow._pipeline_floor())
    want, want_warn = _suggest(jwindow.suggest_window_parameters, tol, sigma)
    got, got_warn = _suggest(pwindow.suggest_window_parameters, tol, sigma)
    assert (got["window"], got["m"], got["sigma"]) == (want["window"], want["m"], want["sigma"])
    assert got["predicted_rel_l2"] == pytest.approx(want["predicted_rel_l2"], rel=1e-12)
    assert got_warn == want_warn


@pytest.mark.parametrize("window", ["es", "kb"])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_error_model_equals_jax(window, sigma):
    for m in range(1, 9):
        assert pwindow._window_error_model(window, m, sigma, 4e-5) == pytest.approx(
            jwindow._window_error_model(window, m, sigma, 4e-5), rel=1e-12)


def test_port_floor_choice_meets_tolerance(rng):
    n, dim, N = 1200, 2, 32
    pos, _ = points(rng, n, dim)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    ref = tp.ndft_adjoint(torch.from_numpy(x).double(), torch.from_numpy(pos).double(), N=N)
    ms = []
    for tol in (1e-3, 1e-4, 1e-5):
        p = tp.suggest_window_parameters(tol)
        ms.append(p["m"])
        assert p["predicted_rel_l2"] <= tol
        y = tp.nfft_adjoint(x, pos, bandwidth=N, cutoff=p["m"], sigma=p["sigma"],
                            window=p["window"], strategy="binned", device="cpu")
        err = rel_l2(y.numpy(), ref.numpy())
        assert err <= p["predicted_rel_l2"], (p, err)
    assert ms == sorted(ms)
    with pytest.warns(UserWarning, match="reachable"):
        assert tp.suggest_window_parameters(1e-12)["m"] <= 8


def test_complex_override_matches_jax(rng):
    n, N, m = 80, 16, 3
    pos, _ = points(rng, n, 2)
    x = rng.standard_normal((n, 2)).astype(np.float32)
    spec = rng.standard_normal((1, N, N, 2)).astype(np.float32)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=2, N=N))
    try:
        for mod in (tn, tp):
            mod.set_complex_override(False)
        kw = {"device": "cpu"}
        pairs = [
            (tn.nfft_adjoint(x, pos, bandwidth=N, cutoff=m, real_output=True),
             tp.nfft_adjoint(x, pos, bandwidth=N, cutoff=m, real_output=True, **kw)),
            (tn.nfft_forward(spec, pos, cutoff=m, real_output=True),
             tp.nfft_forward(spec, pos, cutoff=m, real_output=True, **kw)),
            (tn.nfft_fastsum(x, coeffs, pos, cutoff=m),
             tp.nfft_fastsum(x, coeffs, pos, cutoff=m, **kw)),
        ]
        for want, got in pairs:
            assert not got.is_complex() and got.shape == tuple(np.shape(want))
            assert rel_l2(got.numpy(), np.asarray(want)) <= 1e-5
        for mod, extra in ((tn, {}), (tp, kw)):
            with pytest.raises(ValueError, match="needs a complex-valued FFT pipeline"):
                mod.nfft_adjoint(x, pos, bandwidth=N, cutoff=m, **extra)
            with pytest.raises(ValueError, match="needs a complex-valued FFT pipeline"):
                mod.nfft_forward(spec, pos, cutoff=m, **extra)
            with pytest.raises(ValueError, match="needs a complex-valued FFT pipeline"):
                mod.nfft_fastsum(x.astype(np.complex64), coeffs, pos, cutoff=m, **extra)
        for mod in (tn, tp):
            mod.set_complex_override(True)
        y_on = tp.nfft_adjoint(x, pos, bandwidth=N, cutoff=m, real_output=True, **kw)
        assert rel_l2(y_on.numpy(), pairs[0][1].numpy()) <= 1e-5
        assert tp.nfft_adjoint(x, pos, bandwidth=N, cutoff=m, **kw).is_complex()
    finally:
        for mod in (tn, tp):
            mod.set_complex_override(None)
    assert jnfft._COMPLEX_OK is None and pnfft._COMPLEX_OK is None


@pytest.mark.parametrize("value,on", [("0", False), ("false", False), ("no", False),
                                      ("1", True)])
def test_complex_env_variable(monkeypatch, value, on):
    monkeypatch.setenv("TORCH_NFFT_TPU_COMPLEX", value)
    assert pnfft._complex_ok() is on
    pnfft.set_complex_override(not on)
    try:
        assert pnfft._complex_ok() is (not on)
    finally:
        pnfft.set_complex_override(None)
