"""Parity of the port's padded-state surgery, 2x2 eigen-decomposition,
symmetric packing, time integration and samplers with the JAX package
(float64, CPU).

* ``prune``, ``compact_scatter`` and the masks of ``split`` are exact; the
  moved means, scalings, transforms and values of ``split`` agree to rtol
  1e-12 (atol 1e-15): they pass through a 2x2 eigen-decomposition, where
  libm's sqrt may differ in the last ulp.
* ``pack_symmetric``/``unpack_symmetric`` are exact; ``sym_eig2x2`` and
  ``principal_axis`` rtol 1e-12, including the isotropic case.
* ``time_integrate`` rtol 1e-14.
* The samplers are checked by structure (ranges, bands, shapes, seeding):
  torch and JAX draw different random numbers.

Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu import gaussians as jg
from pigs_tpu import pde as jpde
from pigs_tpu.models import state as jstate
from pigs_tpu_torch import gaussians as tg
from pigs_tpu_torch import pde as tpde
from pigs_tpu_torch.models import state as tstate
from pigs_tpu_torch.utils import sampling as tsampling

N = 48


def t(x):
    return torch.from_numpy(np.array(x))


def random_state(seed, free=0.4, d=2):
    """numpy fields of a padded state: 6 boundary slots, a random share of
    free slots, one isotropic interior Gaussian (slot 7)."""
    rng = np.random.default_rng(seed)
    boundary = np.arange(N) < 6
    active = boundary | (rng.uniform(size=N) > free)
    active[7] = True
    means = rng.normal(size=(N, d))
    scaling = np.exp(rng.normal(size=(N, d)) * 0.3 - 2.0)
    transforms = rng.normal(size=(N, d * (d - 1) // 2))
    scaling[7] = scaling[7, 0]
    transforms[7] = 0.0
    u = rng.normal(size=(N, 2))
    return means, scaling, transforms, u, active, boundary


def both(fields):
    return (jstate.MixtureState(*map(jnp.asarray, fields)),
            tstate.MixtureState(*map(t, fields)))


def state_close(got, want, rtol=1e-12):
    for f in want._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-15)


@pytest.mark.parametrize("seed", range(4))
def test_compact_scatter_exact(seed):
    rng = np.random.default_rng(seed)
    free = rng.uniform(size=N) < [0.1, 0.5, 0.9, 0.0][seed]
    want = rng.uniform(size=N) < 0.5
    j = np.asarray(jstate.compact_scatter(jnp.asarray(free), jnp.asarray(want)))
    got = tstate.compact_scatter(t(free), t(want))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), j)


@pytest.mark.parametrize("seed", range(3))
def test_prune_exact(seed):
    fields = random_state(seed)
    keep = np.random.default_rng(seed + 9).uniform(size=N) > 0.5
    js, ts = both(fields)
    state_close(tstate.prune(ts, t(keep)), jstate.prune(js, jnp.asarray(keep)),
                rtol=0)
    assert int(tstate.active_count(ts)) == int(jstate.active_count(js))


@pytest.mark.parametrize("seed,free", [(0, 0.4), (1, 0.8), (2, 0.1)])
@pytest.mark.parametrize("d", [1, 2])
def test_split_matches_jax(seed, free, d):
    fields = random_state(seed, free, d)
    want = np.random.default_rng(seed + 20).uniform(size=N) > 0.4
    want[7] = True  # the isotropic Gaussian splits along x
    js, ts = both(fields)
    state_close(tstate.split(ts, t(want)), jstate.split(js, jnp.asarray(want)))


def test_split_at_zero_free_capacity():
    fields = random_state(5, free=0.0)
    fields[4][:] = True
    js, ts = both(fields)
    want = np.arange(N) % 3 == 0
    got = tstate.split(ts, t(want))
    state_close(got, jstate.split(js, jnp.asarray(want)))
    assert int(got.active.sum()) == N
    assert all(torch.isfinite(x).all() for x in got[:4])


@pytest.mark.parametrize("d", [1, 2, 3])
def test_pack_unpack_symmetric_exact(d):
    rng = np.random.default_rng(d)
    a = rng.normal(size=(5, d, d))
    a = a + np.swapaxes(a, -1, -2)
    packed = tg.pack_symmetric(t(a))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jg.pack_symmetric(jnp.asarray(a))))
    np.testing.assert_array_equal(tg.unpack_symmetric(packed, d).numpy(), a)


def test_sym_eig2x2_and_principal_axis():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(20, 2, 2))
    cov = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(2)
    cov[0] = 2.0 * np.eye(2)                     # isotropic
    cov[1] = np.diag([0.5, 3.0])                 # diagonal, y dominant
    cov[2] = [[1.0, -0.2], [-0.2, 1.0]]          # equal diagonal
    jvals, jvecs = jg.sym_eig2x2(jnp.asarray(cov))
    vals, vecs = tg.sym_eig2x2(t(cov))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-12)
    np.testing.assert_allclose(vecs.numpy(), np.asarray(jvecs), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(vecs[0].numpy(), [[1.0, 0.0], [-0.0, 1.0]])
    axis = tg.principal_axis(t(cov))
    np.testing.assert_allclose(axis.numpy(),
                               np.asarray(jg.principal_axis(jnp.asarray(cov))),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(axis[0].numpy(), [2.0, 0.0])
    np.testing.assert_allclose(np.abs(axis[1].numpy()), [0.0, 3.0])
    np.testing.assert_allclose(tg.principal_axis(t(cov[:, :1, :1])).numpy(),
                               cov[:, 0, :1])


@pytest.mark.parametrize("rule", list(tpde.IntegrationRule))
def test_time_integrate(rule):
    rng = np.random.default_rng(4)
    ts = rng.uniform(size=7)
    prev = (rng.normal(size=(7, 1)), rng.normal(size=(7, 2, 1)), None)
    curr = (rng.normal(size=(7, 1)), rng.normal(size=(7, 2, 1)), None)
    want = jpde.time_integrate(jpde.IntegrationRule[rule.name],
                               jnp.asarray(ts),
                               tuple(None if x is None else jnp.asarray(x)
                                     for x in prev),
                               tuple(None if x is None else jnp.asarray(x)
                                     for x in curr))
    got = tpde.time_integrate(rule, t(ts),
                              tuple(None if x is None else t(x) for x in prev),
                              tuple(None if x is None else t(x) for x in curr))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14)


def test_collocation_samples():
    gen = torch.Generator().manual_seed(0)
    s = tsampling.collocation_samples(gen, 4000, 2, scale=1.5,
                                      dtype=torch.float64)
    assert s.shape == (4000, 2) and s.dtype == torch.float64
    assert s.abs().max() <= 1.5 and s.min() < -1.4 and s.max() > 1.4
    again = tsampling.collocation_samples(torch.Generator().manual_seed(0),
                                          4000, 2, scale=1.5,
                                          dtype=torch.float64)
    assert torch.equal(s, again)


def test_boundary_band_samples():
    gen = torch.Generator().manual_seed(1)
    s = tsampling.boundary_band_samples(gen, 4000, scale=2.0).numpy()
    assert s.shape == (4000, 2)
    first, second = s[:2000], s[2000:]
    # First half: x in the band |x| in [1, 1.5] * scale, y tangential.
    assert np.all((np.abs(first[:, 0]) >= 2.0) & (np.abs(first[:, 0]) <= 3.0))
    assert np.all(np.abs(first[:, 1]) <= 3.0)
    assert np.all((np.abs(second[:, 1]) >= 2.0) & (np.abs(second[:, 1]) <= 3.0))
    assert np.all(np.abs(second[:, 0]) <= 3.0)
    # Each band: first quarter negative, second quarter positive.
    assert np.all(first[:1000, 0] < 0) and np.all(first[1000:, 0] > 0)
    assert np.all(second[:1000, 1] < 0) and np.all(second[1000:, 1] > 0)
    with pytest.raises(ValueError, match="divisible by 4"):
        tsampling.boundary_band_samples(gen, 6)
