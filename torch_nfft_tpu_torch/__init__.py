"""PyTorch and CUDA port of the JAX NFFT package, for NVIDIA Hopper (H100).

The binned adjoint and forward NFFT of the JAX package (``nfft_adjoint``,
``nfft_forward`` and the planar entry points) and its fastsum
(``nfft_fastsum``, ``nfft_fastsum_real``), with the spread, gather and
position-gradient window contractions and the user <-> slot permutations
(Benes network and ragged row passes) as hand-written CUDA kernels
(``csrc/*.cu``, built by ``nvcc`` at first CUDA use) and the spectral stage
on ``torch.fft``. Plans come from the host builder (``build_plan``, native
C++ in ``csrc/*.cpp`` built by ``g++`` at first use) or the device builder
(``build_plan_device``); ``plan.with_benes_tables()`` routes the Benes
network. Every transform is differentiable in its values and in the point
positions. It imports neither JAX nor the JAX package.

Without a plan, small problems run the scatter or the one-hot matmul
engine (``strategy=``, the JAX package's four strategies and its
``"auto"`` rule); real inputs and outputs run the spectral stage on half
spectra (stages ``rfftn``/``irfftn``, pruned to the band).

The kernel-matrix layer sits on the fastsum: ``GaussianKernel`` and the
radial kernels (``RadialKernel`` for any profile, ``LaplaceKernel``,
``MaternKernel``, ``InverseMultiquadricKernel``; all ``nn.Module`` objects holding
their coefficients) give a ``GramMatrix`` or an ``AdjacencyMatrix`` per
point set, with slot-layout matvecs, a conjugate-gradient ``solve`` and
the Lanczos eigensolver (``lanczos``, ``eigsh_operator``);
``accuracy_check`` measures the adjoint against the NDFT on a subsample;
the coefficient generators
(``gaussian_analytic_coeffs``, ``gaussian_interpolated_coeffs``,
``interpolated_kernel_coeffs`` and the interpolation grids), the point
utilities and the dense oracles (``ndft_fastsum``,
``exact_trigonometric_matrix``, ``exact_gaussian_matrix``,
``exact_radial_matrix``) come with it. ``operator_from_numpy`` carries a
JAX kernel or operator across.

Plans are saved and loaded in the JAX package's ``.npz`` format
(``save_plan``, ``load_plan``). Batched point sets split into members
(``split_by_batch``) with one plan each, stacked (``build_plan_stack``,
``index_plan``), run the streamed transforms
(``make_streamed_layout``, ``nfft_adjoint_streamed``,
``nfft_forward_streamed``, ``nfft_fastsum_streamed``, and the pair of real
values on half spectra, ``nfft_pair_streamed``): one member's grid at a
time. ``suggest_window_parameters`` picks a window for a tolerance;
``set_complex_override`` switches the complex pipelines off, and
``TORCH_NFFT_TPU_DEBUG=1`` checks the inputs of the entry points.

``trace`` records spans at the port's stage boundaries, off unless
``trace.enable()`` turns it on, and reads the kernels' launch counters.

``parallel`` runs the transforms over ranks of ``torch.distributed``:
point-sharded and grid-sharded transforms and a sharded training step.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without ``device=`` they raise.
"""

from . import parallel, trace
from ._device import resolve_device
from .convert import (
    grid_layout_from_numpy,
    layout_from_numpy,
    operator_from_numpy,
    plan_from_numpy,
    plan_to_numpy,
)
from .models import (
    AbstractMatrix,
    AdjacencyMatrix,
    GaussianKernel,
    GramMatrix,
    InverseMultiquadricKernel,
    LaplaceKernel,
    MaternKernel,
    RadialKernel,
)
from .ops.benes import BenesTables
from .ops.binned import (
    BinnedPlan,
    build_plan,
    build_plan_device,
    from_slot_order,
    gather_binned,
    plan_slot_pos_user,
    spread_binned,
    to_slot_order,
)
from .ops.coeffs import (
    gaussian_analytic_coeffs,
    gaussian_interpolated_coeffs,
    interpolated_kernel_coeffs,
    interpolation_grid,
    radial_interpolation_grid,
)
from .ops.ndft import (
    exact_gaussian_matrix,
    exact_radial_matrix,
    exact_trigonometric_matrix,
    ndft_adjoint,
    ndft_fastsum,
    ndft_forward,
)
from .ops.nfft import (
    clear_plan_cache,
    nfft_adjoint,
    nfft_fastsum,
    nfft_forward,
    set_complex_override,
)
from .ops.planar import (
    nfft_adjoint_planar,
    nfft_fastsum_real,
    nfft_forward_planar,
    nfft_pair_planar,
)
from .ops.plan_io import load_plan, save_plan
from .ops.plan_stack import (
    build_plan_stack,
    index_plan,
    pad_plan_rows,
    split_by_batch,
    squeeze_plan,
    stack_plans,
)
from .ops.streaming import (
    StreamedLayout,
    make_streamed_layout,
    nfft_adjoint_streamed,
    nfft_fastsum_streamed,
    nfft_forward_streamed,
    nfft_pair_streamed,
)
from .ops.window import suggest_window_parameters
from .utils.diagnostics import accuracy_check
from .utils.points import (
    compute_points_center,
    compute_points_radius,
    scale_points_by_norm,
    shift_points_by_center,
)
from .utils.solve import eigsh_operator, lanczos

__all__ = [
    "AbstractMatrix",
    "accuracy_check",
    "AdjacencyMatrix",
    "BenesTables",
    "BinnedPlan",
    "build_plan",
    "build_plan_device",
    "build_plan_stack",
    "clear_plan_cache",
    "compute_points_center",
    "compute_points_radius",
    "eigsh_operator",
    "exact_gaussian_matrix",
    "exact_radial_matrix",
    "exact_trigonometric_matrix",
    "from_slot_order",
    "gather_binned",
    "gaussian_analytic_coeffs",
    "gaussian_interpolated_coeffs",
    "GaussianKernel",
    "GramMatrix",
    "grid_layout_from_numpy",
    "index_plan",
    "interpolated_kernel_coeffs",
    "interpolation_grid",
    "InverseMultiquadricKernel",
    "lanczos",
    "LaplaceKernel",
    "layout_from_numpy",
    "load_plan",
    "make_streamed_layout",
    "MaternKernel",
    "ndft_adjoint",
    "ndft_fastsum",
    "ndft_forward",
    "nfft_adjoint",
    "nfft_adjoint_planar",
    "nfft_adjoint_streamed",
    "nfft_fastsum",
    "nfft_fastsum_real",
    "nfft_fastsum_streamed",
    "nfft_forward",
    "nfft_forward_planar",
    "nfft_forward_streamed",
    "nfft_pair_planar",
    "nfft_pair_streamed",
    "operator_from_numpy",
    "pad_plan_rows",
    "parallel",
    "plan_from_numpy",
    "plan_slot_pos_user",
    "plan_to_numpy",
    "radial_interpolation_grid",
    "RadialKernel",
    "resolve_device",
    "save_plan",
    "scale_points_by_norm",
    "set_complex_override",
    "shift_points_by_center",
    "split_by_batch",
    "spread_binned",
    "squeeze_plan",
    "stack_plans",
    "StreamedLayout",
    "suggest_window_parameters",
    "to_slot_order",
    "trace",
]
