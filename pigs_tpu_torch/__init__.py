"""pigs-tpu in PyTorch: the Gaussian-mixture PDE model on an NVIDIA GPU.

A port of :mod:`pigs_tpu` (JAX) that keeps its module names and its public
layouts, so each function here has a counterpart there of the same name and
the parity tests compare like with like.  The package imports ``torch`` and
numpy only; the JAX package is the reference it is tested against.

Layer map (the first slice: the PN rollout of a trained model):

  ops       mixture evaluation (CUDA kernel K1 + its plain twin), dense oracle,
            neighbour aggregation (plain torch matmuls)
  gaussians covariance / conic construction
  models    padded mixture state, dynamics network, forward step
  train     rollout and its metrics
  convert   flax parameter trees -> torch state dicts
"""

from pigs_tpu_torch.pde import IntegrationRule, Problem, pde_rhs

__all__ = ["Problem", "IntegrationRule", "pde_rhs"]
