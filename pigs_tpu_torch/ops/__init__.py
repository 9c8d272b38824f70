"""Compute ops: mixture evaluation (CUDA kernels K1-K3 and their plain
twins, the dense oracle) and neighbour aggregation (plain torch, and the
fused form: CUDA kernels K4/K5 in ``aggregate_kernel``)."""

from pigs_tpu_torch.ops.aggregate import aggregate_neighbors, neighbor_mask
from pigs_tpu_torch.ops.mixture import eval_mixture, eval_mixture_image
from pigs_tpu_torch.ops.oracle import MixtureFields, eval_mixture_dense

__all__ = ["eval_mixture_dense", "eval_mixture", "eval_mixture_image",
           "MixtureFields", "aggregate_neighbors", "neighbor_mask"]
