"""Parity of the port's initial state and forward step with the JAX package
(float64, CPU, capacity 160, nx=6).

The JAX network is initialised at random and its parameters converted; both
sides step the same state.  Tolerance: rtol 1e-10 of each output's scale --
float64 through the mixture evaluation, the network and the Euler update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.models import model as jmodel
from pigs_tpu.pde import IntegrationRule as JRule
from pigs_tpu.pde import Problem as JProblem
from pigs_tpu.train.pn import TrainConfig, init_training
from pigs_tpu_torch import convert
from pigs_tpu_torch.models import model as tmodel
from pigs_tpu_torch.pde import IntegrationRule, Problem

RTOL = 1e-10
PROBLEMS = ["BURGERS", "WAVE", "NAVIER_STOKES", "TEST", "POISSON"]


def flatten(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def configs(name, nx=6, capacity=160):
    jcfg = jmodel.ModelConfig.create(JProblem[name], JRule.TRAPEZOID, nx=nx,
                                     ny=nx, capacity=capacity,
                                     dtype=jnp.float64)
    tcfg = tmodel.ModelConfig.create(Problem[name], IntegrationRule.TRAPEZOID,
                                     nx=nx, ny=nx, capacity=capacity,
                                     dtype=torch.float64)
    return jcfg, tcfg


def torch_network(tcfg, jparams):
    freqs = np.array(jax.random.normal(jax.random.PRNGKey(42),
                                       ((25 - 1) // tcfg.d // 2,)) * 10.0)
    net = tmodel.make_network(tcfg, frequencies=torch.from_numpy(freqs))
    net.load_state_dict(convert.params_from_flax(flatten(jparams)))
    return net


def close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * max(np.abs(want).max(), 1.0))


def test_config_create_matches():
    for name in PROBLEMS:
        jcfg, tcfg = configs(name, nx=20, capacity=None)
        assert tcfg.capacity == jcfg.capacity == 1664
        assert tcfg.period == jcfg.period
        assert tuple(tcfg.weights) == tuple(jcfg.weights)
        assert tuple(tcfg.coeff) == tuple(jcfg.coeff)
    assert tmodel.ModelConfig.create(Problem.BURGERS, nx=30,
                                    ny=30).capacity == 1928


@pytest.mark.parametrize("name", PROBLEMS)
def test_make_initial_state(name):
    jcfg, tcfg = configs(name)
    js = jmodel.make_initial_state(jcfg)
    ts = tmodel.make_initial_state(tcfg)
    for field in js._fields:
        close(getattr(ts, field), getattr(js, field))
    assert ts.means.dtype == torch.float64 and ts.capacity == 160


@pytest.mark.parametrize("name", PROBLEMS)
def test_forward_step(name):
    jcfg, tcfg = configs(name)
    network, params, _, _ = init_training(jcfg, TrainConfig(n_epochs=1,
                                                            seed=3))
    t = 0.3 if name == "POISSON" else 0.0
    js = jmodel.make_initial_state(jcfg)
    # Perturb the interior values so every Gaussian carries a field.
    rng = np.random.default_rng(4)
    noise = rng.normal(size=js.u.shape) * 0.1 * np.asarray(js.interior)[:, None]
    js = js._replace(u=js.u + noise)
    jnew, jdeltas = jmodel.forward_step(jcfg, network, params, js, t=t)

    ts = tmodel.make_initial_state(tcfg)
    ts = ts._replace(u=ts.u + torch.from_numpy(noise))
    tnew, tdeltas = tmodel.forward_step(tcfg, torch_network(tcfg, params), ts,
                                        t=t)
    for field in jnew._fields:
        close(getattr(tnew, field), getattr(jnew, field))
    for got, want in zip(tdeltas, jdeltas):
        close(got, want)
    # Boundary Gaussians never move.
    b = ts.boundary
    assert torch.equal(tnew.means[b], ts.means[b])


@pytest.mark.parametrize("name", ["BURGERS", "TEST"])
def test_randomize_state_with_jax_draws(name):
    """The static randomized IC on the JAX package's own draws: four normals
    shaped like the state (BURGERS at n=5, not the config's nx), or five
    uniforms (TEST)."""
    jcfg, tcfg = configs(name)
    key = jax.random.PRNGKey(9)
    want = jmodel.randomize_state(jcfg, key, n=5)
    ks = jax.random.split(key, 8)
    if name == "TEST":
        draws = [float(jax.random.uniform(k)) for k in ks[:5]]
    else:
        base = jmodel.make_initial_state(jcfg, n=5)
        draws = [np.array(jax.random.normal(k, x.shape, jnp.float64))
                 for k, x in zip(ks, (base.means, base.u, base.scaling,
                                      base.transforms))]
    got = tmodel.randomize_state(tcfg, None, n=5, draws=draws)
    for field in want._fields:
        close(getattr(got, field), getattr(want, field))
    # Drawn from a generator instead: the same layout, noise on the interior.
    drawn = tmodel.randomize_state(tcfg, torch.Generator().manual_seed(0),
                                   n=5)
    assert torch.equal(drawn.active, got.active)
    assert not torch.equal(drawn.means, got.means)
