"""Dense O(m*n) Gaussian-mixture evaluation: the port's oracle.

Port of :mod:`pigs_tpu.ops.oracle`.  With ``d = x - mu_i``, ``C_i`` the conic
and ``P = C_i d``::

  g_i(x)   = exp(-0.5 * d^T C_i d)
  u        = sum_i v_i g_i                                          (m, c)
  du/dx_a  = sum_i -P_a g_i v_i                                     (m, d, c)
  d2u      = sum_i (P_a P_b - C_ab) g_i v_i                         (m, d, d, c)
  d3u      = sum_i (C_ab P_c + C_ac P_b + C_bc P_a - P_a P_b P_c) g_i v_i

Plain torch, any d, any float dtype, differentiable by autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["MixtureFields", "wrap_displacement", "eval_mixture_dense"]


class MixtureFields(NamedTuple):
    """Mixture value and spatial derivatives; fields past the order are None."""

    u: torch.Tensor                       # (m, c)
    ux: Optional[torch.Tensor] = None     # (m, d, c)
    uxx: Optional[torch.Tensor] = None    # (m, d, d, c)  full Hessian
    uxxx: Optional[torch.Tensor] = None   # (m, d, d, d, c)


def wrap_displacement(delta: torch.Tensor, period) -> torch.Tensor:
    """Wrap displacements onto the torus ``[-period/2, period/2)`` per axis.

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    return delta - period * torch.round(delta / period)


def eval_mixture_dense(
    means: torch.Tensor,
    conics: torch.Tensor,
    values: torch.Tensor,
    samples: torch.Tensor,
    order: int = 0,
    mask: Optional[torch.Tensor] = None,
    period: Optional[float] = None,
) -> MixtureFields:
    """Evaluate the mixture and its derivatives up to ``order`` at ``samples``.

    Args:
      means: ``(n, d)``; conics: ``(n, d, d)``; values: ``(n, c)``;
      samples: ``(m, d)``; mask: optional ``(n,)`` bool, inactive Gaussians
      contribute exactly zero; period: optional torus period.
    """
    delta = samples[:, None, :] - means[None, :, :]          # (m, n, d)
    if period is not None:
        delta = wrap_displacement(delta, period)
    P = torch.einsum("nab,mnb->mna", conics, delta)          # (m, n, d)
    g = torch.exp(-0.5 * torch.einsum("mna,mna->mn", delta, P))
    if mask is not None:
        g = g * mask.to(g.dtype)[None, :]
    gv = g[:, :, None] * values[None, :, :]                  # (m, n, c)

    u = gv.sum(dim=1)
    ux = uxx = uxxx = None
    if order >= 1:
        ux = -torch.einsum("mna,mnc->mac", P, gv)
    if order >= 2:
        w2 = P[:, :, :, None] * P[:, :, None, :] - conics[None]
        uxx = torch.einsum("mnab,mnc->mabc", w2, gv)
    if order >= 3:
        CP = (conics[None, :, :, :, None] * P[:, :, None, None, :]
              + conics[None, :, :, None, :] * P[:, :, None, :, None]
              + conics[None, :, None, :, :] * P[:, :, :, None, None])
        PPP = (P[:, :, :, None, None] * P[:, :, None, :, None]
               * P[:, :, None, None, :])
        uxxx = torch.einsum("mnabe,mnc->mabec", CP - PPP, gv)
    return MixtureFields(u=u, ux=ux, uxx=uxx, uxxx=uxxx)
