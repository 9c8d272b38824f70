"""Adam with optax's semantics, as a functional update of a parameter list.

The JAX package trains with ``optax.inject_hyperparams(adam)`` (optionally
chained after ``optax.clip_by_global_norm``) and sets the learning rate
before every step.  This module reproduces that arithmetic:

* clipping: ``g`` if ``||g|| < clip`` else ``g / ||g|| * clip``, with the
  global norm over all tensors (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
  to the norm and is not the same);
* Adam: the count is incremented first, ``mu = (1 - b1) g + b1 mu``,
  ``nu = (1 - b2) g^2 + b2 nu``, bias-corrected by ``1 - b^count``, and the
  parameters move by ``-lr * mu_hat / (sqrt(nu_hat) + eps)``;
* skip-nonfinite: when any raw gradient is not finite, parameters, mu, nu
  and count all keep their old values.  The choice is made on the device,
  so the step never waits for the host.

On CUDA float32 parameters :func:`adam_update` is one launch of the CUDA
kernel K6 (:mod:`pigs_tpu_torch.ops.optim_kernel`); everywhere else (the
CPU, float64) it runs :func:`adam_update_plain`, the same arithmetic in
per-tensor PyTorch operations (``torch.where`` for the skip), which is
also K6's plain twin.  Either way the update is functional on the state:
the old state's tensors are left as they were, and only the parameters
are written in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from pigs_tpu_torch.ops import optim_kernel

__all__ = ["AdamState", "adam_init", "adam_update", "adam_update_plain",
           "global_norm"]


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: one moment tensor per parameter, in
    parameter order and shape, and the int32 step count, all on the
    parameters' device.  ``mu`` and ``nu`` are lists, or after a K6 step
    :class:`~pigs_tpu_torch.ops.optim_kernel.FlatMoments` (sequences of
    views of one flat buffer each)."""

    mu: Sequence[torch.Tensor]
    nu: Sequence[torch.Tensor]
    count: torch.Tensor


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    params = list(params)
    return AdamState(
        mu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
            for p in params],
        nu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
            for p in params],
        count=torch.zeros((), dtype=torch.int32, device=params[0].device))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor (the
    2-norm of the per-tensor 2-norms)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tensors))))


def _all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor: every element of every tensor is finite.  The
    max-norm of a tensor is NaN or inf exactly when one element is."""
    norms = torch._foreach_norm(list(tensors), float("inf"))
    return torch.isfinite(torch.stack(norms)).all()


@torch.no_grad()
def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: AdamState,
                lr: torch.Tensor, clip_norm: Optional[float] = None,
                skip_nonfinite: bool = False, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> AdamState:
    """One optax Adam step: updates ``params`` in place and returns the new
    state.  ``lr`` is a 0-d tensor (``base_lr * loss_weight``) or a float.
    CUDA float32 parameters take K6, every other case
    :func:`adam_update_plain`."""
    params = list(params)
    if params[0].is_cuda and params[0].dtype is torch.float32:
        return AdamState(*optim_kernel.adam_step(
            params, list(grads), state.mu, state.nu, state.count, lr,
            clip_norm, skip_nonfinite, b1, b2, eps))
    return adam_update_plain(params, grads, state, lr, clip_norm,
                             skip_nonfinite, b1, b2, eps)


@torch.no_grad()
def adam_update_plain(params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor], state: AdamState,
                      lr: torch.Tensor, clip_norm: Optional[float] = None,
                      skip_nonfinite: bool = False, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8) -> AdamState:
    """:func:`adam_update` in per-tensor PyTorch operations, on any device
    and dtype: the path of the CPU and of float64, and K6's plain twin."""
    params, grads = list(params), list(grads)
    state = state._replace(mu=list(state.mu), nu=list(state.nu))
    dtype = params[0].dtype
    if skip_nonfinite:
        finite = _all_finite(grads)
    if clip_norm is not None:
        norm = global_norm(grads)
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                     clip_norm)
        keep = norm < clip_norm
        grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]

    mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                            torch._foreach_mul(state.mu, b1))
    sq = torch._foreach_mul(grads, grads)
    nu = torch._foreach_add(torch._foreach_mul(sq, 1.0 - b2),
                            torch._foreach_mul(state.nu, b2))
    count = state.count + 1
    steps = count.to(dtype)
    bias1 = 1.0 - torch.pow(torch.full_like(steps, b1), steps)
    bias2 = 1.0 - torch.pow(torch.full_like(steps, b2), steps)
    mu_hat = torch._foreach_div(mu, bias1)
    nu_hat = torch._foreach_div(nu, bias2)
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
    updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -lr)
    new_params = torch._foreach_add(params, updates)

    if skip_nonfinite:
        new_params = [torch.where(finite, a, b)
                      for a, b in zip(new_params, params)]
        mu = [torch.where(finite, a, b) for a, b in zip(mu, state.mu)]
        nu = [torch.where(finite, a, b) for a, b in zip(nu, state.nu)]
        count = torch.where(finite, count, state.count)
    for p, new in zip(params, new_params):
        p.copy_(new)
    return AdamState(mu=list(mu), nu=list(nu), count=count)
