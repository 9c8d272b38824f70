"""PointNet-style dynamics network (port of :mod:`pigs_tpu.models.dynamics`).

The same architecture as the flax modules: a learned global canonical
transform (``InputTransform``: a ``LatentTransform`` encoder, a masked
mean-pool over active Gaussians, and per-quantity ``TransformNet`` heads), a
per-Gaussian input projection, two heads of neighbour aggregation, and a delta
head emitting (dmeans, dscaling, dtransforms, du).  Parameters load from a
flax tree through :mod:`pigs_tpu_torch.convert`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from pigs_tpu_torch.ops.aggregate import aggregate_neighbors_factored

__all__ = ["WaveAct", "RBFAct", "MLP", "LatentTransform", "TransformNet", "InputTransform",
           "DynamicsNetwork", "Deltas", "HeadInputs", "default_frequencies",
           "LATENT_SIZE", "ATTENTION_HEADS", "EMBEDDING_SIZE"]

LATENT_SIZE = 16
L1_SIZE = 16
L2_SIZE = 32
L3_SIZE = 48
EMBEDDING_SIZE = 25
ATTENTION_HEADS = 2

# The fixed embedding frequencies, copied from the JAX package:
# jax.random.normal(PRNGKey(42), (F,)) * 10 drawn in float32, F = 24 // d // 2.
# A constant of the trained models, never redrawn.
_FREQUENCIES = {
    2: (-0.28304616, 4.6713185, 2.9570296, 1.5354592, -1.2403282, 2.1692314),
    1: (-0.28304616, 4.6713185, 2.9570296, 1.5354592, -1.2403282, 2.1692314,
        -14.40879, 7.558599, 5.214096, 9.101704, -3.844966, 11.398233),
}


def default_frequencies(d: int) -> torch.Tensor:
    """The embedding frequencies the JAX package uses for dimension ``d``."""
    if d not in _FREQUENCIES:
        raise ValueError(f"no frequency constants for d={d}")
    return torch.tensor(_FREQUENCIES[d], dtype=torch.float32)


class Deltas(NamedTuple):
    dmeans: torch.Tensor           # (N, d)
    dscaling: torch.Tensor         # (N, d)
    dtransforms: torch.Tensor      # (N, T)
    du: torch.Tensor               # (N, c)
    head_magnitudes: torch.Tensor  # (heads,)


class HeadInputs(NamedTuple):
    """What one head's neighbour aggregation takes besides the means and the
    neighbourhood: ``features (N, L)``, ``transform (L, L)`` (the raw
    parameter minus 1), ``queries``/``keys (N, K)``, ``frequencies (F,)``
    and ``distance_transform (L, 2E)`` (minus 1)."""

    features: torch.Tensor
    transform: torch.Tensor
    queries: torch.Tensor
    keys: torch.Tensor
    frequencies: torch.Tensor
    distance_transform: torch.Tensor


class WaveAct(nn.Module):
    """Learned ``w1 sin(x) + w2 cos(x)`` activation (part of the API; the
    default network uses tanh).  ``w1``, ``w2`` start at one."""

    def __init__(self):
        super().__init__()
        self.w1 = nn.Parameter(torch.ones(1))
        self.w2 = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return self.w1 * torch.sin(x) + self.w2 * torch.cos(x)


class RBFAct(nn.Module):
    """Gaussian radial activation ``exp(-b (x - c)^2)``; ``b`` starts at one
    and ``c (in_dim,)`` at zero."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.b = nn.Parameter(torch.ones(1))
        self.c = nn.Parameter(torch.zeros(in_dim))

    def forward(self, x):
        return torch.exp(-self.b * (x - self.c) ** 2)


class MLP(nn.Module):
    """Linear stack with Tanh between layers (none after the last)."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        sizes = [in_features, *features]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x


class LatentTransform(nn.Module):
    """Per-Gaussian encoder, Tanh after every layer including the last."""

    def __init__(self, in_features: int):
        super().__init__()
        sizes = [in_features, L1_SIZE, L2_SIZE, LATENT_SIZE]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return x


class TransformNet(nn.Module):
    """Global latent -> near-identity ``(k, k)`` transform ``I + A``."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k
        self.mlp = MLP(LATENT_SIZE, [L3_SIZE, L2_SIZE, k * k])

    def forward(self, latent):
        a = self.mlp(latent)
        eye = torch.eye(self.k, dtype=latent.dtype, device=latent.device)
        return eye + a.reshape(self.k, self.k)


class InputTransform(nn.Module):
    """Learned canonical transforms applied to all per-Gaussian quantities."""

    def __init__(self, c: int, d: int, pde_size: int):
        super().__init__()
        self.c, self.d = c, d
        in_features = d + d * d + c + 1 + c + 2 * d * c + pde_size
        self.latent_net = LatentTransform(in_features)
        self.transform_net = TransformNet(d)
        self.transform_u_net = TransformNet(c)
        self.transform_ux_net = TransformNet(d * c)
        self.transform_uxx_net = TransformNet(d * c)
        self.transform_pde_net = TransformNet(pde_size)

    def forward(self, means, full_cov, u, boundaries, sample_u, sample_ux,
                sample_uxx, sample_pde, active):
        n = means.shape[0]
        cov_flat = full_cov.reshape(n, self.d * self.d)
        params = torch.cat(
            [means, cov_flat, u, boundaries[:, None].to(u.dtype),
             sample_u, sample_ux, sample_uxx, sample_pde], dim=-1)
        per_gaussian = self.latent_net(params)
        # Masked mean-pool over the active Gaussians.
        w = active.to(per_gaussian.dtype)[:, None]
        latent = (torch.sum(per_gaussian * w, dim=0)
                  / torch.clamp(torch.sum(w), min=1.0))

        t = self.transform_net(latent)
        t_u = self.transform_u_net(latent)
        t_ux = self.transform_ux_net(latent)
        t_uxx = self.transform_uxx_net(latent)
        t_pde = self.transform_pde_net(latent)
        return (
            means @ t.T,
            torch.einsum("ab,nbc->nac", t, full_cov).reshape(n, -1),
            u @ t_u.T,
            sample_u @ t_u.T,
            sample_ux @ t_ux.T,
            sample_uxx @ t_uxx.T,
            sample_pde @ t_pde.T,
        )


class DynamicsNetwork(nn.Module):
    """Delta-prediction network over padded ``(N, ...)`` inputs with an
    ``(N,)`` active mask and an ``(N, N)`` neighbour mask; the deltas of
    inactive slots are zero.

    ``frequencies`` defaults to the JAX package's float32 constants; the
    attention params ``transform_h`` / ``distance_transform_h`` are stored
    raw, in U[0, 2), with ``- 1.0`` applied in the forward, as in flax.
    """

    def __init__(self, c: int, d: int, pde_size: int, width_mult: int = 1,
                 frequencies: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c, self.d, self.pde_size = c, d, pde_size
        m = width_mult
        LATENT, L1, L2, L3 = (LATENT_SIZE * m, L1_SIZE * m, L2_SIZE * m,
                              L3_SIZE * m)
        self.transform_size = d * (d - 1) // 2
        self.input_transform = InputTransform(c, d, pde_size)
        n_params = d * d + c + 1 + c + 2 * d * c + pde_size
        self.input_projection = MLP(n_params, [L1, L2, L3, LATENT])
        mid = (LATENT + L1) // 2
        self.query = nn.ModuleList(MLP(LATENT, [LATENT, LATENT, mid, L1])
                                   for _ in range(ATTENTION_HEADS))
        self.key = nn.ModuleList(MLP(LATENT, [LATENT, LATENT, mid, L1])
                                 for _ in range(ATTENTION_HEADS))
        for h in range(ATTENTION_HEADS):
            self.register_parameter(
                f"transform_{h}", nn.Parameter(torch.empty(LATENT, LATENT)))
            self.register_parameter(
                f"distance_transform_{h}",
                nn.Parameter(torch.empty(LATENT, EMBEDDING_SIZE * 2)))
        l = ATTENTION_HEADS // 2 + 1
        out_size = 2 * d + self.transform_size + c
        self.delta_net = MLP((1 + ATTENTION_HEADS) * LATENT,
                             [l * LATENT, LATENT, LATENT, L3, L2, out_size])
        if frequencies is None:
            frequencies = default_frequencies(d)
        self.register_buffer("frequencies", frequencies.clone(),
                             persistent=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw the parameters as flax initialises them: Linear weights
        lecun-normal (normal truncated at 2 std, fan-in variance), biases
        zero, attention params U[0, 2)."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                std = (1.0 / module.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, std=std, a=-2.0 * std,
                                      b=2.0 * std, generator=generator)
                nn.init.zeros_(module.bias)
        for h in range(ATTENTION_HEADS):
            for name in (f"transform_{h}", f"distance_transform_{h}"):
                p = getattr(self, name)
                p.copy_(2.0 * torch.rand(p.shape, generator=generator,
                                         dtype=p.dtype, device=p.device))

    def aggregation_inputs(self, means, full_cov, u, boundaries, sample_u,
                           sample_ux, sample_uxx, sample_pde, active):
        """The per-Gaussian features and, for each head, the inputs of its
        neighbour aggregation, built from the network's own submodules;
        :meth:`forward` aggregates exactly these."""
        dtype = means.dtype
        _, t_cov, t_u, t_sample_u, t_ux, t_uxx, t_pde = self.input_transform(
            means, full_cov, u, boundaries, sample_u, sample_ux, sample_uxx,
            sample_pde, active)
        t_params = torch.cat(
            [t_cov, t_u, boundaries[:, None].to(dtype), t_sample_u, t_ux,
             t_uxx, t_pde], dim=-1)
        features = self.input_projection(t_params)
        frequencies = self.frequencies.to(dtype)
        heads = [HeadInputs(
            features, (getattr(self, f"transform_{h}") - 1.0).to(dtype),
            self.query[h](features), self.key[h](features), frequencies,
            (getattr(self, f"distance_transform_{h}") - 1.0).to(dtype))
            for h in range(ATTENTION_HEADS)]
        return features, heads

    def forward(self, means, full_cov, u, boundaries, sample_u, sample_ux,
                sample_uxx, sample_pde, active, nbr_mask,
                period: Optional[float] = None) -> Deltas:
        d = self.d
        dtype = means.dtype
        features, heads = self.aggregation_inputs(
            means, full_cov, u, boundaries, sample_u, sample_ux, sample_uxx,
            sample_pde, active)
        all_features = [features]
        magnitudes = []
        for head in heads:
            agg = aggregate_neighbors_factored(*head, means=means,
                                               mask=nbr_mask, period=period)
            magnitudes.append(torch.mean(agg ** 2))
            all_features.append(agg)

        deltas = self.delta_net(torch.cat(all_features, dim=-1))
        gate = active.to(dtype)[:, None]
        T = self.transform_size
        return Deltas(deltas[:, :d] * gate,
                      deltas[:, d:2 * d] * gate,
                      deltas[:, 2 * d:2 * d + T] * gate,
                      deltas[:, 2 * d + T:] * gate,
                      torch.stack(magnitudes))
