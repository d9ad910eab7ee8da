"""PyTorch port vs JAX package: the planar adjoint, forward and pair, the
NDFT oracles and gates, and the port's package boundary.

The same plan (built by JAX, carried across with ``plan_from_numpy``) runs
in both packages. The transforms agree to rel-L2 3e-5: the port's spectral
stage is a C2C FFT where the JAX package multiplies by DFT matrices, a
different float32 arithmetic on the same math.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import points, port_plan, rel_l2

import torch_nfft_tpu_torch as tp
from torch_nfft_tpu_torch.ops.planar import pair_stages
from torch_nfft_tpu.ops import binned as jbinned
from torch_nfft_tpu.ops import ndft as jndft
from torch_nfft_tpu.ops import planar as jplanar

REL = 3e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [
    # dim, N, B, C, m, sigma, window
    (1, 32, 1, 1, 3, 2.0, "gaussian"),
    (2, 16, 2, 2, 3, 2.0, "es"),
    (3, 8, 1, 1, 3, 2.0, "es"),
    (3, 8, 2, 2, 2, 1.625, "kb"),
]


def _case(rng, dim, N, B, C, m, sigma, window, n=200):
    pos, batch = points(rng, n, dim, B)
    x = rng.standard_normal((n, C)).astype(np.float32)
    jplan = jbinned.build_plan(pos, batch, N=N, m=m, sigma=sigma, batch_size=B, K=128,
                               window=window)
    kw = dict(batch_size=B, m=m, sigma=sigma, window=window)
    return pos, batch, x, jplan, port_plan(jplan), kw


@pytest.mark.parametrize("dim,N,B,C,m,sigma,window", CASES)
def test_pair_matches_jax(rng, dim, N, B, C, m, sigma, window):
    pos, batch, x, jplan, plan, kw = _case(rng, dim, N, B, C, m, sigma, window)
    ref = jplanar.nfft_pair_planar(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(batch),
                                   jplan, N=N, **kw)
    got = tp.nfft_pair_planar(x, pos, batch, plan, N=N, device="cpu", **kw)
    assert got.shape == (len(x), C) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), np.asarray(ref)) <= REL


def test_pair_runs_its_stages_in_order(rng):
    """The stages that chip_smoke.py times one by one are the pair's own:
    run in order they give nfft_pair_planar's result."""
    pos, batch, x, jplan, plan, kw = _case(rng, 3, 8, 2, 2, 2, 1.625, "kb")
    stages = pair_stages(plan, N=8, m=2, sigma=1.625, window="kb")
    assert [name for name, _ in stages] == [
        "slot_values", "spread kernel", "fold", "rfftn", "irfftn", "unfold",
        "gather kernel", "unslot_values"]
    v = torch.from_numpy(x)
    for _, fn in stages:
        v = fn(v)
    assert torch.equal(v, tp.nfft_pair_planar(x, pos, batch, plan, N=8, device="cpu", **kw))


@pytest.mark.parametrize("dim,N,B,C,m,sigma,window", CASES)
def test_adjoint_forward_match_jax(rng, dim, N, B, C, m, sigma, window):
    pos, batch, x, jplan, plan, kw = _case(rng, dim, N, B, C, m, sigma, window)
    jr, ji = jplanar.nfft_adjoint_planar(jnp.asarray(x), jnp.asarray(pos),
                                         jnp.asarray(batch), jplan, N=N, **kw)
    yr, yi = tp.nfft_adjoint_planar(x, pos, batch, plan, N=N, device="cpu", **kw)
    assert yr.shape == (B,) + (N,) * dim + (C,)
    assert rel_l2(yr.numpy() + 1j * yi.numpy(), np.asarray(jr) + 1j * np.asarray(ji)) <= REL

    # forward of an independent spectrum, both planes and real output
    shape = (B,) + (N,) * dim + (C,)
    sr = rng.standard_normal(shape).astype(np.float32)
    si = rng.standard_normal(shape).astype(np.float32)
    jfr, jfi = jplanar.nfft_forward_planar(jnp.asarray(sr), jnp.asarray(si), jnp.asarray(pos),
                                           jnp.asarray(batch), jplan, dim=dim, **kw)
    fr, fi = tp.nfft_forward_planar(sr, si, pos, batch, plan, dim=dim, device="cpu", **kw)
    assert rel_l2(fr.numpy() + 1j * fi.numpy(), np.asarray(jfr) + 1j * np.asarray(jfi)) <= REL
    zr, zi = tp.nfft_forward_planar(sr, None, pos, batch, plan, dim=dim, real_output=True,
                                    device="cpu", **kw)
    jzr, _ = jplanar.nfft_forward_planar(jnp.asarray(sr), None, jnp.asarray(pos),
                                         jnp.asarray(batch), jplan, dim=dim,
                                         real_output=True, **kw)
    assert zi is None and rel_l2(zr.numpy(), np.asarray(jzr)) <= REL


def test_pair_is_adjoint_then_real_forward(rng):
    pos, batch, x, jplan, plan, kw = _case(rng, 3, 8, 2, 2, 3, 2.0, "es")
    z = tp.nfft_pair_planar(x, pos, batch, plan, N=8, device="cpu", **kw)
    yr, yi = tp.nfft_adjoint_planar(x, pos, batch, plan, N=8, device="cpu", **kw)
    zr, _ = tp.nfft_forward_planar(yr, yi, pos, batch, plan, dim=3, real_output=True,
                                   device="cpu", **kw)
    assert rel_l2(z.numpy(), zr.numpy()) < 1e-6


def test_own_plan_matches_carried_plan(rng):
    """plan=None builds the port's device plan; it runs the same math as the
    JAX plan carried across."""
    pos, batch, x, jplan, plan, kw = _case(rng, 2, 16, 2, 1, 3, 2.0, "es")
    a = tp.nfft_pair_planar(x, pos, batch, plan, N=16, device="cpu", **kw)
    b = tp.nfft_pair_planar(x, pos, batch, None, N=16, device="cpu", **kw)
    assert rel_l2(b.numpy(), a.numpy()) < 1e-6


def test_ndft_oracles_match_jax(rng):
    pos, batch = points(rng, 120, 2, 2)
    x = rng.standard_normal((120, 3)).astype(np.float32)
    ref = jndft.ndft_adjoint(jnp.asarray(x), jnp.asarray(pos), batch, N=8)
    got = tp.ndft_adjoint(torch.from_numpy(x), torch.from_numpy(pos), batch, N=8)
    assert got.shape == (2, 8, 8, 3) and rel_l2(got.numpy(), np.asarray(ref)) < 1e-5
    ref_f = jndft.ndft_forward(ref, jnp.asarray(pos), batch)
    got_f = tp.ndft_forward(got, torch.from_numpy(pos), batch)
    assert got_f.shape == (120, 3) and rel_l2(got_f.numpy(), np.asarray(ref_f)) < 1e-5


@pytest.mark.parametrize("dim,N", [(2, 16), (3, 32)])
def test_ndft_gate_error_no_worse_than_jax(dim, N):
    """bench.py's gate (n=400, es, m=2, sigma=1.625) against a float64 NDFT:
    the port's error is at most 1.1x the JAX package's."""
    rng = np.random.default_rng(0)
    pos = rng.random((400, dim), dtype=np.float32) - 0.5
    pos /= 4 * np.abs(pos).max()
    x = rng.standard_normal((400, 2)).astype(np.float32)
    kw = dict(batch_size=1, N=N, m=2, sigma=1.625, window="es")
    jr, ji = jplanar.nfft_adjoint_planar(jnp.asarray(x), jnp.asarray(pos),
                                         jnp.zeros(400, jnp.int32), **kw)
    yr, yi = tp.nfft_adjoint_planar(x, pos, None, device="cpu", **kw)
    ref = tp.ndft_adjoint(torch.from_numpy(x).double(), torch.from_numpy(pos).double(), N=N)
    err_jax = rel_l2(np.asarray(jr) + 1j * np.asarray(ji), ref.numpy())
    err_port = rel_l2(yr.numpy() + 1j * yi.numpy(), ref.numpy())
    assert err_port < 1e-3 and err_port <= 1.1 * err_jax


@pytest.mark.parametrize("bad", [dict(window="gaussian"), dict(m=2), dict(sigma=1.5),
                                 dict(N=10), dict(batch_size=1)])
def test_plan_mismatch_raises(rng, bad):
    pos, batch, x, jplan, plan, kw = _case(rng, 2, 16, 2, 1, 3, 2.0, "es")
    kw = {**kw, "N": 16, **bad}
    with pytest.raises(ValueError, match="plan"):
        tp.nfft_pair_planar(x, pos, batch, plan, device="cpu", **kw)


def test_entry_points_raise_without_a_card(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, batch = points(rng, 50, 2)
    x = rng.standard_normal((50, 1)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.nfft_pair_planar(x, pos, None, batch_size=1, N=8, m=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.nfft_adjoint_planar(x, pos, None, batch_size=1, N=8, m=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.build_plan_device(pos, N=8, m=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.nfft_pair_planar(x, pos, None, batch_size=1, N=8, m=2, device="cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, numpy as np\n"
        "import torch_nfft_tpu_torch as tp\n"
        "rng = np.random.default_rng(0)\n"
        "pos = (rng.random((300, 3), dtype=np.float32) - 0.5) / 2\n"
        "x = rng.standard_normal((300, 1)).astype(np.float32)\n"
        "z = tp.nfft_pair_planar(x, pos, None, batch_size=1, N=8, m=2, sigma=2.0,\n"
        "                        window='es', strategy='binned', device='cpu')\n"
        "assert z.shape == (300, 1)\n"
        "G = tp.GaussianKernel(0.4, dim=3, bandwidth=8, cutoff=3, device='cpu')(pos)\n"
        "y = G @ x\n"
        "assert y.shape == (300, 1) and bool(y.isfinite().all())\n"
        "R = tp.MaternKernel(0.4, nu=1.5, dim=3, bandwidth=8, cutoff=3, device='cpu')(pos)\n"
        "assert bool((R @ x).isfinite().all())\n"
        "w, v = tp.eigsh_operator(R, 2, num_iters=12)\n"
        "assert w.shape == (2,) and v.shape == (300, 2)\n"
        "assert tp.accuracy_check(pos, 8, 3, device='cpu') < 1e-2\n"
        "import os, tempfile, torch.distributed as dist\n"
        "from torch_nfft_tpu_torch import parallel as par\n"
        "rdv = os.path.join(tempfile.mkdtemp(), 'rdv')\n"
        "dist.init_process_group('gloo', init_method='file://' + rdv, rank=0, world_size=1)\n"
        "ys = par.nfft_adjoint_sharded(x, pos, bandwidth=8, cutoff=2,\n"
        "                              mesh=par.make_mesh(device_type='cpu'))\n"
        "dist.destroy_process_group()\n"
        "assert ys.shape == (1, 8, 8, 8, 1) and bool(ys.isfinite().all())\n"
        "import torch\n"
        "from torch_nfft_tpu_torch import torch_compat as tc\n"
        "xt = torch.from_numpy(x).requires_grad_()\n"
        "tc.nfft_adjoint(xt, torch.from_numpy(pos), bandwidth=8).abs().sum().backward()\n"
        "assert xt.grad.shape == (300, 1)\n"
        "import examples_torch.rbf_interpolation, examples_torch.graph_smoothing\n"
        "import examples_torch.learn_kernel, examples_torch.multichip_training\n"
        "import examples_torch.grid_sharded_large\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'torch_nfft_tpu' or m.startswith('torch_nfft_tpu.'))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_planar_entry_points_take_a_strategy(rng):
    """ROADMAP.md C2: the three planar entry points take ``strategy`` as the
    JAX functions do. With a plan every strategy runs the binned engine on
    it; without one the plan-free strategies run their engines, within
    1e-5 of the binned engine; an unknown name is an error."""
    pos, batch, x, jplan, plan, kw = _case(rng, 2, 16, 2, 2, 3, 2.0, "es")
    N = 16
    spec = rng.standard_normal((2, N, N, 2)).astype(np.float32)
    calls = {
        "pair": lambda p, **s: tp.nfft_pair_planar(x, pos, batch, p, N=N, device="cpu",
                                                   **kw, **s),
        "adjoint": lambda p, **s: tp.nfft_adjoint_planar(x, pos, batch, p, N=N,
                                                         device="cpu", **kw, **s),
        "forward": lambda p, **s: tp.nfft_forward_planar(spec, spec, pos, batch, p, dim=2,
                                                         device="cpu", **kw, **s),
    }

    def planes(out):
        return out if isinstance(out, tuple) else (out,)

    for name, call in calls.items():
        base = planes(call(plan))
        for strategy in ("binned", "scatter", "matmul"):
            for a, b in zip(base, planes(call(plan, strategy=strategy))):
                assert torch.equal(a, b), name
        for strategy in ("scatter", "matmul"):
            for a, b in zip(base, planes(call(None, strategy=strategy))):
                assert rel_l2(b.numpy(), a.numpy()) <= 1e-5, (name, strategy)
        with pytest.raises(ValueError, match="unknown strategy"):
            call(plan, strategy="fast")
    z = tp.nfft_pair_planar(x[:, :1], pos, None, batch_size=1, N=16, m=3,
                            strategy="binned", device="cpu")
    ref = jplanar.nfft_pair_planar(jnp.asarray(x[:, :1]), jnp.asarray(pos),
                                   jnp.zeros(len(pos), jnp.int32), batch_size=1, N=16,
                                   m=3, strategy="binned")
    assert rel_l2(z.numpy(), np.asarray(ref)) <= REL
