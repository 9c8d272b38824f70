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
  and count all keep their old values.  The choice is made on the device
  with ``torch.where``, so the step never waits for the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

__all__ = ["AdamState", "adam_init", "adam_update", "global_norm"]


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: one moment tensor per parameter and
    the int32 step count, all on the parameters' device."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
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
    state.  ``lr`` is a 0-d tensor (``base_lr * loss_weight``)."""
    params, grads = list(params), list(grads)
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
