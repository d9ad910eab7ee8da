"""The band-pruned half-spectrum stages (``ops/fft.py``:
``spectral_adjoint_half``, ``spectral_forward_half``) against the
whole-grid formulation they replaced: ``rfftn`` of the whole grid, cropped
to the half spectrum, and the half spectrum embedded in a zeroed
M x ... x (M // 2 + 1) array, ``irfftn``. The whole-grid formulation is a
test helper (``_torch_port.py``, which the card tests share), not part of
the package.

Dims 1-3, N even and odd, M = 2N, M = 13/8 N (the headline's 416/256) and
M of no tile's multiple, several leading slices (B > 1, C in 1, 2, 8), the
three windows, each through both layouts of the last axis's transform
(cuFFT's own turned lines, or contiguous lines and ``turn_half``, forced by
``TURN_KERNEL_ABOVE``): outputs to 1e-5 of the largest entry. Gradients:
float64 ``gradcheck`` of both stages, and the pair's grid gradient against
autograd through the whole-grid formulation.
"""

import pytest
import torch
from _torch_port import whole_adjoint, whole_forward

from torch_nfft_tpu_torch.ops import fft as pfft
from torch_nfft_tpu_torch.ops.planar import pair_spectral_stages


def assert_close(got, ref, frac=1e-5):
    """max |got - ref| <= frac * max |ref|."""
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert float((got - ref).abs().max()) <= frac * float(ref.abs().max())


# dim, N, M, leading shape (B, C), window
GRIDS = [
    (1, 16, 32, (2, 1), "gaussian"),
    (1, 15, 25, (1, 8), "es"),
    (2, 16, 32, (2, 2), "kb"),
    (2, 9, 18, (1, 8), "gaussian"),
    (2, 16, 26, (3, 1), "es"),
    (2, 8, 21, (1, 2), "kb"),
    (3, 8, 16, (2, 1), "es"),
    (3, 16, 26, (1, 2), "gaussian"),
    (3, 7, 14, (2, 8), "kb"),
    (3, 9, 19, (1, 2), "es"),
    (3, 16, 32, (1, 8), "gaussian"),
    (3, 8, 13, (2, 2), "kb"),
]
LAYOUTS = ["cufft turned", "turn kernel"]
CASES = [(*grid, layout) for grid in GRIDS for layout in LAYOUTS
         if grid[0] > 1 or layout == LAYOUTS[0]]  # 1D has one layout


@pytest.fixture
def layout(request, monkeypatch):
    """Both layouts of the last axis's transform at these small M."""
    if request.param == "turn kernel":
        monkeypatch.setattr(pfft, "TURN_KERNEL_ABOVE", 0)
    return request.param


@pytest.mark.parametrize("dim,N,M,lead,window,layout", CASES, indirect=["layout"])
def test_pruned_stages_match_the_whole_grid(dim, N, M, lead, window, layout):
    """Both stages against the whole-grid formulation, and the forward of
    the adjoint's half spectrum through the pair's band filter."""
    m, sigma = 2, M / N
    gen = torch.Generator().manual_seed(dim * 1000 + N * 10 + M)
    g = torch.randn(lead + (M,) * dim, generator=gen)
    phi = pfft._phi_half(dim, N, m, sigma, window, g.device)
    half = pfft.spectral_adjoint_half(g, dim, N, m, sigma, window)
    assert half.shape == lead + (2 * (N // 2) + 1,) * (dim - 1) + (N // 2 + 1,)
    assert_close(half, whole_adjoint(g, dim, N, phi))
    H = torch.randn(half.shape, dtype=torch.complex64, generator=gen)
    got = pfft.spectral_forward_half(H, dim, N, M, m, sigma, window)
    assert got.shape == g.shape and got.dtype == torch.float32
    assert_close(got, whole_forward(H, dim, N, M, phi))
    w = pfft.band_filter_half(dim, N)
    hw = half if w is None else half * w
    assert_close(pfft.spectral_forward_half(hw, dim, N, M, m, sigma, window),
                 whole_forward(hw, dim, N, M, phi))


@pytest.mark.parametrize("layout", LAYOUTS, indirect=True)
@pytest.mark.parametrize("stage", ["adjoint", "forward"])
@pytest.mark.parametrize("dim,N,M", [(3, 4, 7), (2, 5, 8)])
def test_pruned_stages_gradcheck(dim, N, M, stage, layout):
    """float64 gradcheck of each stage (fast mode: random projections of
    the Jacobian): each is the other's adjoint under autograd, up to the
    C2R's count of each last-axis term."""
    m, sigma = 2, M / N
    gen = torch.Generator().manual_seed(11)
    if stage == "adjoint":
        x = torch.randn((1, 2) + (M,) * dim, dtype=torch.float64, generator=gen)

        def fn(v):
            return pfft.spectral_adjoint_half(v, dim, N, m, sigma, "kb")
    else:
        x = torch.randn((2, 1) + (2 * (N // 2) + 1,) * (dim - 1) + (N // 2 + 1,),
                        dtype=torch.complex128, generator=gen)

        def fn(v):
            return pfft.spectral_forward_half(v, dim, N, M, m, sigma, "kb")
    assert torch.autograd.gradcheck(fn, (x.requires_grad_(),), fast_mode=True)


@pytest.mark.parametrize("layout", LAYOUTS, indirect=True)
@pytest.mark.parametrize("dim,N,M,lead", [(3, 8, 16, (1, 2)), (3, 9, 15, (2, 1)),
                                          (2, 16, 26, (1, 3))])
def test_pair_stages_gradient_matches_the_whole_grid(dim, N, M, lead, layout):
    """The pair's spectral stages under autograd: the grid's gradient of
    <pair stages(g), r> against autograd through rfftn and irfftn."""
    m, sigma, window = 4, 2.0, "gaussian"
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(lead + (M,) * dim, generator=gen, requires_grad=True)
    r = torch.randn(lead + (M,) * dim, generator=gen)
    out = g
    for _, fn in pair_spectral_stages(dim=dim, N=N, M=M, m=m, sigma=sigma, window=window,
                                      device=None):
        out = fn(out)
    got, = torch.autograd.grad((out * r).sum(), g)
    phi = pfft._phi_half(dim, N, m, sigma, window, None)
    w = pfft.band_filter_half(dim, N)
    h = whole_adjoint(g, dim, N, phi)
    whole = whole_forward(h if w is None else h * w, dim, N, M, phi)
    ref, = torch.autograd.grad((whole * r).sum(), g)
    assert_close(out.detach(), whole.detach())
    assert_close(got, ref)


def test_turn_half_plain_turns_and_pads():
    """turn_half's CPU version: the kept values turned into rows, and back
    as zero-padded lines."""
    gen = torch.Generator().manual_seed(3)
    R, K, n2 = 10, 7, 4
    src = torch.randn((R, K), dtype=torch.complex64, generator=gen)
    rows = pfft.turn_half(src, R, K, n2, True)
    assert torch.equal(rows, src[:, :n2].t())
    back = pfft.turn_half(rows, R, K, n2, False)
    assert torch.equal(back[:, :n2], src[:, :n2]) and not back[:, n2:].any()


@pytest.mark.parametrize("mapped,want", [
    ([], None),
    (["/opt/cuda/lib64/libcufft.so.12"], 0),
    (["/opt/cuda/lib64/libcufft.so.12", "{torch}/lib/libcufft.so.11"], 1),
    (["/opt/cuda/lib64/libcufft.so.12", "{site}/nvidia/cufft/lib/libcufft.so.11"], 1),
    (["/opt/cuda/lib64/libcufft.so.12", "/usr/lib/libcufft.so.11"], None),
])
def test_cufft_library_is_pytorchs_own(mapped, want):
    """Of the mapped cuFFT libraries the card's stages take PyTorch's: the
    one beside its libraries or in its ``nvidia/cufft`` package, else the
    only one; none where several others are mapped."""
    import os

    from torch_nfft_tpu_torch.ops import cufft

    here = os.path.dirname(os.path.realpath(torch.__file__))
    paths = [p.format(torch=here, site=os.path.dirname(here)) for p in mapped]
    assert cufft._torch_cufft(paths) == (None if want is None else paths[want])
