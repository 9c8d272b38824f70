"""The multi-process layer: the ``(data, model)`` mesh, the sharded and
ring mixture evaluation and the data-parallel training step, over
``torch.distributed`` (port of :mod:`pigs_tpu.parallel`)."""

from pigs_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated
from pigs_tpu_torch.parallel.sharded import (eval_mixture_ring,
                                             eval_mixture_sharded)

__all__ = ["make_mesh", "data_sharding", "replicated", "eval_mixture_sharded",
           "eval_mixture_ring"]
