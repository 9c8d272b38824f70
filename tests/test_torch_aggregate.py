"""Parity of the port's neighbour aggregation with the JAX package (float64).

Inputs are made with numpy from fixed seeds.  Tolerance: rtol 1e-10 of the
output's scale -- the two sides compute the same sums through different
matmul and einsum orders in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.ops import aggregate as jagg
from pigs_tpu_torch.ops import aggregate as tagg

RTOL = 1e-10


def make(seed, n=40, L=16, K=16, F=6, d=2):
    rng = np.random.default_rng(seed)
    E = 1 + 2 * F * d
    means = rng.uniform(-1.0, 1.0, (n, d))
    diag = np.exp(rng.normal(size=(n, d)) * 0.3 - 3.0)
    cov = np.zeros((n, d, d))
    for a in range(d):
        cov[:, a, a] = diag[:, a]
    active = rng.uniform(size=n) > 0.2
    return dict(
        features=rng.normal(size=(n, L)),
        transform=rng.uniform(-1.0, 1.0, (L, L)),
        queries=rng.normal(size=(n, K)),
        keys=rng.normal(size=(n, K)),
        frequencies=rng.normal(size=(F,)) * 10.0,
        distance_transform=rng.uniform(-1.0, 1.0, (L, 2 * E)),
        means=means), cov, active


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1.0))


def test_positional_embedding():
    rng = np.random.default_rng(0)
    rel = rng.normal(size=(5, 7, 2))
    f = rng.normal(size=(6,)) * 10.0
    close(tagg.positional_embedding(torch.from_numpy(rel), torch.from_numpy(f)),
          jagg.positional_embedding(jnp.asarray(rel), jnp.asarray(f)))


@pytest.mark.parametrize("period", [None, 2.0])
@pytest.mark.parametrize("include_self", [False, True])
def test_neighbor_mask(period, include_self):
    args, cov, active = make(1)
    want = jagg.neighbor_mask(jnp.asarray(args["means"]), jnp.asarray(cov),
                              active=jnp.asarray(active), period=period,
                              include_self=include_self)
    got = tagg.neighbor_mask(torch.from_numpy(args["means"]),
                             torch.from_numpy(cov),
                             active=torch.from_numpy(active), period=period,
                             include_self=include_self)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()  # the case tests both outcomes


@pytest.mark.parametrize("period", [None, 2.0])
@pytest.mark.parametrize("fn", ["aggregate_neighbors",
                                "aggregate_neighbors_factored"])
def test_aggregate_matches_jax(fn, period):
    args, cov, active = make(2)
    # Means spread past the period so that wrapped pairs occur.
    args["means"] = args["means"] * (1.4 if period else 1.0)
    mask = jagg.neighbor_mask(jnp.asarray(args["means"]), jnp.asarray(cov),
                              active=jnp.asarray(active), sigma_cut=12.0,
                              period=period)
    want = getattr(jagg, fn)(**{k: jnp.asarray(v) for k, v in args.items()},
                             mask=mask, period=period)
    got = getattr(tagg, fn)(**{k: torch.from_numpy(v) for k, v in args.items()},
                            mask=torch.from_numpy(np.array(mask)),
                            period=period)
    assert got.shape == (40, 16)
    close(got, want)


@pytest.mark.parametrize("period", [None, 2.0])
def test_factored_equals_dense_in_torch(period):
    args, cov, active = make(3, d=2)
    targs = {k: torch.from_numpy(v) for k, v in args.items()}
    targs["means"] = targs["means"] * 1.4
    mask = tagg.neighbor_mask(targs["means"], torch.from_numpy(cov),
                              active=torch.from_numpy(active), sigma_cut=12.0,
                              period=period)
    dense = tagg.aggregate_neighbors(**targs, mask=mask, period=period)
    factored = tagg.aggregate_neighbors_factored(**targs, mask=mask,
                                                 period=period)
    close(factored, dense.numpy())
    # A Gaussian with no neighbour aggregates exactly zero.
    lonely = ~mask.any(dim=1)
    assert lonely.any()
    assert (factored[lonely] == 0).all()


@pytest.mark.parametrize("period", [None, 2.0])
@pytest.mark.parametrize("fn", ["aggregate_neighbors",
                                "aggregate_neighbors_factored"])
def test_aggregate_gradcheck_f64(fn, period):
    """torch.autograd.gradcheck of the aggregation over every tensor input
    (features, transform, queries, keys, frequencies, distance_transform and
    the means) at a tiny size, the neighbour mask held fixed."""
    args, cov, active = make(4, n=6, L=4, K=4, F=2)
    names = list(args)
    targs = [torch.from_numpy(args[k]).requires_grad_() for k in names]
    mask = tagg.neighbor_mask(targs[-1].detach(), torch.from_numpy(cov),
                              active=torch.from_numpy(active), sigma_cut=40.0,
                              period=period)
    assert 0 < int(mask.sum()) < mask.numel()
    f = getattr(tagg, fn)
    assert torch.autograd.gradcheck(
        lambda *a: f(**dict(zip(names, a)), mask=mask, period=period),
        targs)
