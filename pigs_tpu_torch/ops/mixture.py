"""Public mixture evaluation and its dispatch (port of :mod:`pigs_tpu.ops.mixture`).

``impl="auto"``: d in {1, 2} goes through the fused K1 wrapper, which
launches the CUDA kernel on CUDA tensors and runs its plain twin on CPU
tensors; d=1 is embedded in d=2.  Its gradients run K2 (and K3 when the
samples require grad) on CUDA and their plain twins on the CPU.  Other d go
to the blockwise plain path on the CPU.  On CUDA, anything the kernel does
not take (not float32, d=3) raises unless the caller asks for
``impl="plain"``, the blockwise path chunked over samples, which runs
anywhere and is differentiated by torch autograd through the dense oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

from pigs_tpu_torch.ops.mixture_kernel import eval_mixture_fused
from pigs_tpu_torch.ops.oracle import MixtureFields, eval_mixture_dense

__all__ = ["eval_mixture", "eval_mixture_region", "eval_mixture_image",
           "embed_d1"]


def embed_d1(means, conics, samples):
    """A d=1 mixture's ``(means, conics, samples)`` on the d=2 path: a zero
    second coordinate and a conic whose second row and column are zero, so
    the exponent and every derivative in the leading index are exactly the
    1D ones."""
    n, m = means.shape[0], samples.shape[0]
    means2 = torch.cat([means.reshape(n, 1), means.new_zeros((n, 1))], dim=-1)
    conics2 = conics.new_zeros((n, 2, 2))
    conics2[:, 0, 0] = conics.reshape(n)
    samples2 = torch.cat([samples.reshape(m, 1), samples.new_zeros((m, 1))],
                         dim=-1)
    return means2, conics2, samples2


def _eval_d1_via_d2(means, conics, values, samples, order, mask, period):
    """d=1 on the d=2 path (:func:`embed_d1`)."""
    means2, conics2, samples2 = embed_d1(means, conics, samples)
    out = eval_mixture_fused(means2, conics2, values, samples2, order=order,
                             mask=mask, period=period)
    return MixtureFields(
        u=out.u,
        ux=None if out.ux is None else out.ux[:, :1],
        uxx=None if out.uxx is None else out.uxx[:, :1, :1],
        uxxx=None if out.uxxx is None else out.uxxx[:, :1, :1, :1],
    )


def eval_mixture(
    means: torch.Tensor,
    conics: torch.Tensor,
    values: torch.Tensor,
    samples: torch.Tensor,
    order: int = 0,
    mask: Optional[torch.Tensor] = None,
    period: Optional[float] = None,
    sample_chunk: int = 1024,
    impl: str = "auto",
    diff_samples: bool = True,
) -> MixtureFields:
    """Evaluate a Gaussian mixture field and its derivatives up to ``order``.

    Same contract as :func:`pigs_tpu_torch.ops.oracle.eval_mixture_dense`:
    full ``(n, d, d)`` conics, fields in the oracle's full layouts.

    ``diff_samples`` is kept for parity with the JAX signature and changes
    nothing: whether the sample-side backward (K3) runs follows from
    ``samples.requires_grad``.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    d = samples.shape[-1]
    if impl == "auto":
        fused = d in (1, 2)
        if samples.is_cuda and not (fused and samples.dtype == torch.float32):
            raise ValueError(
                f"eval_mixture: no CUDA kernel for d={d}, {samples.dtype}; "
                "pass impl='plain' for the plain path")
        if fused:
            if d == 1:
                return _eval_d1_via_d2(means, conics, values, samples, order,
                                       mask, period)
            return eval_mixture_fused(means, conics, values, samples,
                                      order=order, mask=mask, period=period)

    blocks = [eval_mixture_dense(means, conics, values, block, order=order,
                                 mask=mask, period=period)
              for block in torch.split(samples, sample_chunk)]
    return MixtureFields(*[
        None if parts[0] is None else torch.cat(parts)
        for parts in zip(*blocks)])


def eval_mixture_region(means, conics, values, center, size: int, dx: float,
                        order: int = 0, mask=None, period=None
                        ) -> MixtureFields:
    """Evaluate on the ``size^d`` grid of offsets (:func:`region_kernel`)
    around ``center``."""
    from pigs_tpu_torch.utils.sampling import region_kernel
    d = means.shape[-1]
    offsets = region_kernel(size, dx, d, dtype=means.dtype,
                            device=means.device)
    center = torch.as_tensor(center, dtype=means.dtype, device=means.device)
    return eval_mixture(means, conics, values, center.reshape(1, d) + offsets,
                        order=order, mask=mask, period=period)


def eval_mixture_image(means, conics, values, res: int, scale: float = 1.0,
                       mask=None, period=None) -> torch.Tensor:
    """Render the field on the image grid: ``(res, res, c)``, xy indexing,
    y axis flipped."""
    from pigs_tpu_torch.utils.sampling import image_samples
    samples = image_samples(res, scale, dtype=means.dtype, device=means.device)
    out = eval_mixture(means, conics, values, samples, order=0, mask=mask,
                       period=period)
    return out.u.reshape(res, res, -1)
