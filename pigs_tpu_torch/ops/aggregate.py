"""Neighbour aggregation over Gaussians (port of :mod:`pigs_tpu.ops.aggregate`).

Per Gaussian i over its neighbours j (a masked attention)::

  emb(r)   = [pe(r), pe(2r)],  pe(r) = [1, sin(f_k r_a), cos(f_k r_a)]
  alpha_ij = masked softmax_j(<q_i, k_j> / sqrt(K))
  out_i    = sum_j alpha_ij (W_t f_j) * (W_d emb(mu_j - mu_i))

``aggregate_neighbors`` forms the (n, n, 2E) embedding; the model calls
``aggregate_neighbors_factored``, which gives the same result with matmuls
only, through the angle-addition identities.  Plain torch ops: on the model's
path aggregation is matmuls, not a kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["positional_embedding", "neighbor_mask", "aggregate_neighbors",
           "aggregate_neighbors_factored"]


def positional_embedding(rel: torch.Tensor, frequencies: torch.Tensor
                         ) -> torch.Tensor:
    """Sinusoidal embedding of displacements: ``(..., d) -> (..., 1 + 2*F*d)``,
    flat index ``k*d + a`` within the sin and cos blocks."""
    phases = rel[..., None, :] * frequencies[:, None]        # (..., F, d)
    flat = phases.reshape(*phases.shape[:-2], -1)
    const = torch.ones((*rel.shape[:-1], 1), dtype=rel.dtype, device=rel.device)
    return torch.cat([const, torch.sin(flat), torch.cos(flat)], dim=-1)


def _wrap(rel: torch.Tensor, period: Optional[float]) -> torch.Tensor:
    if period is None:
        return rel
    return rel - period * torch.round(rel / period)


def neighbor_mask(
    means: torch.Tensor,
    covariances: torch.Tensor,
    active: Optional[torch.Tensor] = None,
    sigma_cut: float = 3.0,
    period: Optional[float] = None,
    include_self: bool = False,
) -> torch.Tensor:
    """Boolean ``(n, n)`` mask of pairs whose centres lie within
    ``sigma_cut * (r_i + r_j)``, ``r = sqrt(max diag(Sigma))``.

    The distance is ``sqrt(sum(rel**2))``, the formula of ``jnp.linalg.norm``,
    so a pair at the threshold is decided as the JAX package decides it
    wherever the two backends round alike.
    """
    n = means.shape[0]
    rel = _wrap(means[None, :, :] - means[:, None, :], period)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    radius = torch.sqrt(torch.amax(
        torch.diagonal(covariances, dim1=-2, dim2=-1), dim=-1))
    cut = sigma_cut * (radius[:, None] + radius[None, :])
    mask = dist <= cut
    if not include_self:
        mask = mask & ~torch.eye(n, dtype=torch.bool, device=means.device)
    if active is not None:
        mask = mask & active[None, :] & active[:, None]
    return mask


def _masked_softmax(queries, keys, mask):
    """Softmax over the masked keys; rows with no neighbour are exactly 0."""
    dtype = queries.dtype
    K = queries.shape[-1]
    logits = (queries @ keys.T) / math.sqrt(K)
    neg = torch.tensor(torch.finfo(dtype).min, dtype=dtype,
                       device=queries.device)
    logits = torch.where(mask, logits, neg)
    logits_max = torch.amax(logits, dim=-1, keepdim=True).detach()
    unnorm = torch.exp(logits - logits_max) * mask
    denom = torch.sum(unnorm, dim=-1, keepdim=True)
    return unnorm / torch.clamp(denom, min=1e-30)


def aggregate_neighbors(features, transform, queries, keys, frequencies,
                        distance_transform, means, mask,
                        period: Optional[float] = None) -> torch.Tensor:
    """Dense form: features ``(n, L)``, transform ``(L, L)``, queries/keys
    ``(n, K)``, frequencies ``(F,)``, distance_transform ``(L, 2E)``, means
    ``(n, d)``, mask ``(n, n)``; returns ``(n, L)``."""
    rel = _wrap(means[None, :, :] - means[:, None, :], period)  # mu_j - mu_i
    emb = torch.cat([positional_embedding(rel, frequencies),
                     positional_embedding(2.0 * rel, frequencies)], dim=-1)
    alpha = _masked_softmax(queries, keys, mask)
    mapped = features @ transform.T
    gate = torch.einsum("ijE,lE->ijl", emb, distance_transform)
    return torch.einsum("ij,jl,ijl->il", alpha, mapped, gate)


def _trig_tables(means, frequencies):
    """``(s, c)``, each ``(2, n, F, d)``: ``s[p-1, i, k, a] =
    sin(p * f_k * means[i, a])``."""
    phases = means[None, :, None, :] * frequencies[None, None, :, None]
    octave = torch.tensor([1.0, 2.0], dtype=means.dtype, device=means.device)
    phases = phases * octave[:, None, None, None]
    return torch.sin(phases), torch.cos(phases)


def _axis_dmaps(distance_transform, F: int, d: int):
    """Split the ``(L, 2E)`` distance transform into per-(octave, axis)
    sin/cos blocks ``(2, d, L, F)`` each, plus the summed constant columns."""
    L = distance_transform.shape[0]
    E = 1 + 2 * F * d
    dsin, dcos = [], []
    for p in range(2):
        off = p * E
        s_block = distance_transform[:, off + 1:off + 1 + F * d]
        c_block = distance_transform[:, off + 1 + F * d:off + 1 + 2 * F * d]
        dsin.append(torch.movedim(s_block.reshape(L, F, d), -1, 0))
        dcos.append(torch.movedim(c_block.reshape(L, F, d), -1, 0))
    dconst = distance_transform[:, 0] + distance_transform[:, E]
    return torch.stack(dsin), torch.stack(dcos), dconst


def aggregate_neighbors_factored(features, transform, queries, keys,
                                 frequencies, distance_transform, means, mask,
                                 period: Optional[float] = None
                                 ) -> torch.Tensor:
    """:func:`aggregate_neighbors` through the angle-addition factorisation:
    ``sin(f(a_j - a_i)) = s_j c_i - c_j s_i`` and
    ``cos(f(a_j - a_i)) = c_j c_i + s_j s_i`` turn the pair embedding into
    products of per-Gaussian trig tables, so the aggregation is matmuls.  A
    periodic wrap count m in {-1, 0, 1} per axis is a phase shift, handled by
    three masked copies of alpha with phase-rotated coefficients."""
    n, L = features.shape
    d = means.shape[-1]
    F = frequencies.shape[0]

    alpha = _masked_softmax(queries, keys, mask)
    mapped = features @ transform.T                          # (n, L)
    s, c = _trig_tables(means, frequencies)                  # (2, n, F, d)
    dsin, dcos, dconst = _axis_dmaps(distance_transform, F, d)

    out = (alpha @ mapped) * dconst[None, :]

    m_counts = None
    if period is not None:
        rel = means[None, :, :] - means[:, None, :]
        m_counts = torch.clamp(torch.round(rel / period), -1.0, 1.0)

    for a in range(d):
        s_a = torch.cat([s[0, :, :, a], s[1, :, :, a]], dim=-1)   # (n, 2F)
        c_a = torch.cat([c[0, :, :, a], c[1, :, :, a]], dim=-1)
        U = torch.cat([c_a, s_a, c_a, s_a], dim=-1)               # (n, 8F)
        V = torch.cat([s_a, c_a, c_a, s_a], dim=-1)
        T = 8 * F
        VM = (V[:, None, :] * mapped[:, :, None]).reshape(n, L * T)

        ds_a = torch.cat([dsin[0, a], dsin[1, a]], dim=-1)        # (L, 2F)
        dc_a = torch.cat([dcos[0, a], dcos[1, a]], dim=-1)

        if m_counts is None:
            shifts = [(None, alpha)]
        else:
            shifts = [(mval, alpha * (m_counts[:, :, a] == mval))
                      for mval in (-1.0, 0.0, 1.0)]

        for mval, alpha_m in shifts:
            if mval is None or mval == 0.0:
                Dmap = torch.cat([ds_a, -ds_a, dc_a, dc_a], dim=-1)
            else:
                # wrap shift phi = p * f_k * period * m:
                # sin(theta - phi) = cos(phi) sin(theta) - sin(phi) cos(theta)
                phi = frequencies * period * mval
                phi = torch.cat([phi, 2.0 * phi])[None, :]        # (1, 2F)
                cp, sp = torch.cos(phi), torch.sin(phi)
                Dmap = torch.cat([
                    cp * ds_a + sp * dc_a,
                    -cp * ds_a - sp * dc_a,
                    -sp * ds_a + cp * dc_a,
                    -sp * ds_a + cp * dc_a,
                ], dim=-1)                                        # (L, 8F)
            C = (alpha_m @ VM).reshape(n, L, T)
            out = out + torch.einsum("ilt,it,lt->il", C, U, Dmap)
    return out
