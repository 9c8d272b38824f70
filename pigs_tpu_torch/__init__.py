"""pigs-tpu in PyTorch: the Gaussian-mixture PDE model on an NVIDIA GPU.

A port of :mod:`pigs_tpu` (JAX) that keeps its module names and its public
layouts, so each function here has a counterpart there of the same name and
the parity tests compare like with like.  The package imports ``torch`` and
numpy only; the JAX package is the reference it is tested against.

Layer map (the slices so far: PN training and rollout of the Burgers
flagship, Navier-Stokes training and rollout, the no-MLP direct solver, the
NS data pipeline and the fit-to-target initializer):

  ops       mixture evaluation (CUDA kernels K1 forward, K2/K3 backward, and
            their plain twins), dense oracle, neighbour aggregation (plain
            torch matmuls on the network's path; the fused form, CUDA
            kernels K4 forward and K5 backward, beside it)
  gaussians covariance / conic construction, 2x2 eigen-decomposition
  models    padded mixture state with prune/split, dynamics network, forward
            step, sampling, losses, adaptive split, randomized ICs
  train     training (optax-style Adam, epochs, curriculum, EMA,
            checkpoints), rollout and its metrics, the NS dataset and the
            vorticity rollout; the no-MLP direct solver; the fit-to-target
            initializer and the NS data pipeline (generate, curl-fit,
            convert)
  native    mmap .npy reader and row prefetcher (C++ built by g++ under
            build/, host code)
  utils     samplers, FD and spectral reference solvers, the card's name
  convert   flax parameter trees, no-MLP parameters and optax Adam
            states -> torch
"""

from pigs_tpu_torch.pde import IntegrationRule, Problem, pde_rhs

__all__ = ["Problem", "IntegrationRule", "pde_rhs"]
