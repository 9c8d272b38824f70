"""The data-parallel PN training step (port of
:mod:`pigs_tpu.parallel.train`).

The collocation samples split over the ``data`` axis and the network's
parameters are replicated: each rank computes the physics losses on its
sample block, the gradients and the loss are averaged over the ``data``
group (one all-reduce of a flattened buffer: a sum divided by the axis
size, since gloo has no average), and every rank applies the same update.
The losses are means over equal blocks, so the average of the blocks'
means is the global mean; a size that does not divide the axis raises
``ValueError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from pigs_tpu_torch.models.model import (ModelConfig, StepFields,
                                         compute_loss, forward_step,
                                         sample_fields)
from pigs_tpu_torch.models.state import MixtureState
from pigs_tpu_torch.parallel.mesh import (DATA_AXIS, axis_group, axis_size,
                                          data_sharding)
from pigs_tpu_torch.train.optim import adam_update

__all__ = ["make_dp_train_step"]


def make_dp_train_step(mesh, cfg: ModelConfig, network,
                       opt: Optional[Callable] = None):
    """Build the data-parallel training step of ``network`` on ``mesh``.

    Returns ``step(opt_state, state, prev_fields, samples, time_samples,
    bc_samples, lr_scale, t, dt) -> (opt_state, new_state, curr_fields,
    loss)``.  Every rank passes the global ``samples``, ``time_samples``,
    ``bc_samples`` and ``prev_fields`` and works on its ``data`` block of
    them; ``curr_fields`` is that block (``sharded.gather`` assembles it).
    The step runs ``forward_step``, ``sample_fields`` and ``compute_loss``,
    averages the gradients of the total loss and the loss over the ``data``
    group and calls ``opt(params, grads, opt_state, lr_scale)``, which
    updates the parameters in place and returns the new optimizer state
    (default: :func:`pigs_tpu_torch.train.optim.adam_update`).  As in the
    JAX package, no loss term is filtered, weighted or clipped.  The state,
    fields and loss come back detached.
    """
    opt = adam_update if opt is None else opt
    params = list(network.parameters())
    data = data_sharding(mesh)
    group = axis_group(mesh, DATA_AXIS)   # None on a LocalMesh
    size = axis_size(mesh, DATA_AXIS)

    def step(opt_state, state: MixtureState, prev_fields: StepFields,
             samples, time_samples, bc_samples, lr_scale, t: float,
             dt: float):
        samples, time_samples, bc_samples = (
            data(x) for x in (samples, time_samples, bc_samples))
        prev = StepFields(*(None if x is None else data(x)
                            for x in prev_fields))
        with torch.enable_grad():
            new_state, deltas = forward_step(cfg, network, state, t=t)
            curr = sample_fields(cfg, new_state, samples, bc_samples)
            loss = compute_loss(cfg, new_state, deltas, prev, curr, samples,
                                time_samples, t, dt).total
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        loss = loss.detach()
        if group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.reshape(1)])
            dist.all_reduce(flat, group=group)
            flat = flat / size
            parts = torch.split(flat, [g.numel() for g in grads] + [1])
            grads = [p.reshape(g.shape) for p, g in zip(parts, grads)]
            loss = parts[-1].reshape(())
        opt_state = opt(params, grads, opt_state, lr_scale)
        return (opt_state, MixtureState(*(x.detach() for x in new_state)),
                curr.detach(), loss)

    return step
