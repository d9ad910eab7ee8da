"""Multi-rank execution of the NFFT transforms over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/``, whose ``shard_map`` over a
``jax.sharding.Mesh`` becomes one process per rank over a
``DeviceMesh`` (:func:`make_mesh`; NCCL between cards, gloo for ranks that
share one card or the CPU):

* the **points axis** shards the irregular points: every rank spreads its
  block into its own oversampled grid and ONE all-reduce sums the grids
  (adjoint, fastsum); the forward's gather is local once the grid is
  replicated (:mod:`.sharded`);
* the **columns axis** shards the trailing columns, with no communication;
* independent point sets ride a data axis (:func:`make_fastsum_train_step`);
* the **grid axis** shards the oversampled grid itself in axis-0 slabs,
  with one ring shift of the halo (:mod:`.grid_sharded`).

Every rank calls a transform with the same global tensors and gets the
same global result; gradients through the collectives equal those of the
global function (``_comm.py``). The train step alone works on each rank's
block.
"""

from .grid_sharded import (
    GridShardedLayout,
    build_grid_sharded_layout,
    nfft_adjoint_grid_sharded,
    nfft_fastsum_grid_sharded,
    nfft_forward_grid_sharded,
    spectral_adjoint_pruned_dft_sharded0,
    spectral_forward_pruned_dft_sharded0,
)
from .mesh import make_mesh, pad_points
from .sharded import (
    build_sharded_plans,
    nfft_adjoint_sharded,
    nfft_fastsum_sharded,
    nfft_forward_sharded,
    spectral_adjoint_pruned_dft_sharded,
    spectral_forward_pruned_dft_sharded,
)
from .training import make_fastsum_train_step

__all__ = [
    "make_mesh",
    "pad_points",
    "build_sharded_plans",
    "nfft_adjoint_sharded",
    "nfft_forward_sharded",
    "nfft_fastsum_sharded",
    "spectral_adjoint_pruned_dft_sharded",
    "spectral_forward_pruned_dft_sharded",
    "GridShardedLayout",
    "build_grid_sharded_layout",
    "nfft_adjoint_grid_sharded",
    "nfft_fastsum_grid_sharded",
    "nfft_forward_grid_sharded",
    "spectral_adjoint_pruned_dft_sharded0",
    "spectral_forward_pruned_dft_sharded0",
    "make_fastsum_train_step",
]
