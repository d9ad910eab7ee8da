"""PyTorch port vs JAX package: debug-mode input validation
(utils/debug.py).

The port's ``validate_inputs`` raises where the JAX package's does, with
the same message, on NumPy inputs and on tensors; under
``TORCH_NFFT_TPU_DEBUG=1`` the port's ``nfft_adjoint``, ``nfft_forward``
and ``nfft_fastsum`` run it on their points, as the JAX package's do.
"""

import numpy as np
import pytest
import torch
from _torch_port import points

import torch_nfft_tpu as tn
import torch_nfft_tpu_torch as tp
from torch_nfft_tpu.utils.debug import validate_inputs as jvalidate
from torch_nfft_tpu_torch.utils.debug import debug_enabled, validate_inputs


def _cases(pos):
    nan = pos.copy()
    nan[3, 1] = np.nan
    inf = pos.copy()
    inf[0, 0] = np.inf
    return [  # (pos, batch, batch_size, message or None)
        (pos, np.zeros(50, np.int32), 1, None),
        (pos, None, None, None),
        (pos, np.repeat(np.arange(2, dtype=np.int32), 25), 2, None),
        (nan, None, None, "finite"),
        (inf, None, None, "finite"),
        (pos * 3.0, None, None, "1/2"),
        (pos, np.array([1, 0] * 25, np.int32), 2, "sorted"),
        (pos, np.full(50, 5, np.int32), 2, "lie in"),
        (pos, np.full(50, -1, np.int32), 2, "lie in"),
        (pos, np.zeros(49, np.int32), 1, "batch shape"),
    ]


@pytest.mark.parametrize("case", range(10))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_validate_inputs_raises_where_jax_does(rng, case, as_tensor):
    pos, _ = points(rng, 50, 2)
    p, b, bs, msg = _cases(pos)[case]
    args = (p, b, bs)
    if as_tensor:
        args = (torch.from_numpy(p), None if b is None else torch.from_numpy(b), bs)
    if msg is None:
        jvalidate(p, b, bs)
        validate_inputs(*args)
        return
    with pytest.raises(ValueError, match=msg) as jerr:
        jvalidate(p, b, bs)
    with pytest.raises(ValueError, match=msg) as perr:
        validate_inputs(*args)
    assert str(perr.value) == str(jerr.value)


def test_debug_flag(monkeypatch):
    for value, on in (("1", True), ("0", False), ("", False), ("false", False), ("yes", True)):
        monkeypatch.setenv("TORCH_NFFT_TPU_DEBUG", value)
        assert debug_enabled() is on
    monkeypatch.delenv("TORCH_NFFT_TPU_DEBUG")
    assert not debug_enabled()


def test_debug_env_hooks_the_entry_points(rng, monkeypatch):
    pos, _ = points(rng, 50, 2)
    x = rng.standard_normal((50, 1)).astype(np.float32)
    unsorted = np.array([1, 0] * 25, np.int32)
    two = np.repeat(np.arange(2, dtype=np.int32), 25)
    far = pos * 3.0
    spec = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    coeffs = np.asarray(tn.gaussian_analytic_coeffs(0.3, dim=2, N=16))
    calls = [
        lambda m, p, b: m.nfft_adjoint(x, p, b, 16, 4, batch_size=2, **kw(m)),
        lambda m, p, b: m.nfft_forward(spec, p, b, 4, batch_size=2, **kw(m)),
        lambda m, p, b: m.nfft_fastsum(x, coeffs, p, None, b, None, cutoff=4, batch_size=2,
                                       **kw(m)),
    ]

    def kw(m):
        return {"device": "cpu"} if m is tp else {}

    # without the flag the port runs on (results are not checked here)
    monkeypatch.delenv("TORCH_NFFT_TPU_DEBUG", raising=False)
    calls[0](tp, pos, unsorted)
    monkeypatch.setenv("TORCH_NFFT_TPU_DEBUG", "1")
    for call in calls:
        for m in (tn, tp):
            with pytest.raises(ValueError, match="sorted"):
                call(m, pos, unsorted)
            with pytest.raises(ValueError, match="1/2"):
                call(m, far, two)
    # clean inputs still run with debug on
    tp.nfft_adjoint(x, pos, bandwidth=16, cutoff=4, device="cpu")
