"""Compute ops: mixture evaluation (CUDA kernel K1 and its plain twin, the
dense oracle) and neighbour aggregation."""

from pigs_tpu_torch.ops.aggregate import aggregate_neighbors, neighbor_mask
from pigs_tpu_torch.ops.mixture import eval_mixture, eval_mixture_image
from pigs_tpu_torch.ops.oracle import MixtureFields, eval_mixture_dense

__all__ = ["eval_mixture_dense", "eval_mixture", "eval_mixture_image",
           "MixtureFields", "aggregate_neighbors", "neighbor_mask"]
