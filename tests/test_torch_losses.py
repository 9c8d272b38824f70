"""Parity of the port's sampling, losses, adaptive split and randomized
initial conditions with the JAX package (float64, CPU, capacity 192).

* ``sample_fields`` and ``compute_loss`` for all six problems, on a
  perturbed state stepped once by a converted network: rtol 1e-10 of each
  quantity's scale (float64 through the mixture and the network).
* ``adaptive_split`` with the ``value`` criteria (Burgers) and the
  ``vorticity`` criteria (Navier-Stokes): masks exact, fields rtol 1e-10.
* ``grid_state_dynamic`` and the IC noise with JAX's own normal draws
  injected: rtol 1e-12.  ``randomize_state_dynamic`` and the TEST
  randomization by structure (torch draws other numbers than JAX).

Inputs are made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.models import model as jmodel
from pigs_tpu.models.state import MixtureState as JState
from pigs_tpu.pde import IntegrationRule as JRule
from pigs_tpu.pde import Problem as JProblem
from pigs_tpu.train.pn import TrainConfig, init_training
from pigs_tpu_torch import convert
from pigs_tpu_torch.models import model as tmodel
from pigs_tpu_torch.models.state import MixtureState
from pigs_tpu_torch.pde import IntegrationRule, Problem

RTOL = 1e-10
PROBLEMS = ["BURGERS", "DIFFUSION", "WAVE", "NAVIER_STOKES", "TEST", "POISSON"]
CAP = 192


def flatten(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def configs(name, nx=6, split_criteria="value"):
    jcfg = jmodel.ModelConfig.create(JProblem[name], JRule.TRAPEZOID, nx=nx,
                                     ny=nx, capacity=CAP, dtype=jnp.float64,
                                     split_criteria=split_criteria)
    tcfg = tmodel.ModelConfig.create(Problem[name], IntegrationRule.TRAPEZOID,
                                     nx=nx, ny=nx, capacity=CAP,
                                     dtype=torch.float64,
                                     split_criteria=split_criteria)
    return jcfg, tcfg


def close(got, want, rtol=RTOL):
    if want is None:
        assert got is None
        return
    want = np.asarray(want)
    got = got.detach().numpy()
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * max(np.abs(want).max(), 1.0))


def to_torch(jstate):
    return MixtureState(*(torch.from_numpy(np.array(x)) for x in jstate))


def perturbed_state(jcfg, seed):
    """The initial state with every active Gaussian carrying a field and a
    tilted covariance."""
    js = jmodel.make_initial_state(jcfg)
    rng = np.random.default_rng(seed)
    act = np.asarray(js.active)[:, None]
    return js._replace(
        u=js.u + rng.normal(size=js.u.shape) * 0.1 * act,
        transforms=js.transforms + rng.normal(size=js.transforms.shape) * act,
        means=js.means + rng.normal(size=js.means.shape) * 0.02
        * np.asarray(js.interior)[:, None])


def samples(seed, m=40):
    rng = np.random.default_rng(seed)
    smp = rng.uniform(-1, 1, (m, 2))
    bc = np.concatenate([rng.uniform(1, 1.5, (m // 2, 2)),
                         -rng.uniform(1, 1.5, (m // 2, 2))])
    return smp, bc, rng.uniform(0, 1, m)


@pytest.mark.parametrize("name", PROBLEMS)
def test_sample_fields_and_compute_loss(name):
    jcfg, tcfg = configs(name)
    network, params, _, _ = init_training(jcfg, TrainConfig(n_epochs=1,
                                                            seed=2))
    freqs = np.array(jax.random.normal(jax.random.PRNGKey(42), (6,)) * 10.0)
    net = tmodel.make_network(tcfg, frequencies=torch.from_numpy(freqs))
    net.load_state_dict(convert.params_from_flax(flatten(params)))
    js = perturbed_state(jcfg, 1)
    ts = to_torch(js)
    smp, bc, tsamp = samples(2)
    t_ = 0.3 if name == "POISSON" else 0.0

    jprev = jmodel.sample_fields(jcfg, js, jnp.asarray(smp), jnp.asarray(bc))
    tprev = tmodel.sample_fields(tcfg, ts, torch.from_numpy(smp),
                                 torch.from_numpy(bc))
    for got, want in zip(tprev, jprev):
        close(got, want)

    jnew, jd = jmodel.forward_step(jcfg, network, params, js, t=t_)
    jcurr = jmodel.sample_fields(jcfg, jnew, jnp.asarray(smp), jnp.asarray(bc))
    init = jprev.u * 0.5
    jl = jmodel.compute_loss(jcfg, jnew, jd, jprev, jcurr, jnp.asarray(smp),
                             jnp.asarray(tsamp), t_, 0.1, initial_fields=init)
    tnew, td = tmodel.forward_step(tcfg, net, ts, t=t_)
    tcurr = tmodel.sample_fields(tcfg, tnew, torch.from_numpy(smp),
                                 torch.from_numpy(bc))
    tl = tmodel.compute_loss(tcfg, tnew, td, tprev, tcurr,
                             torch.from_numpy(smp), torch.from_numpy(tsamp),
                             t_, 0.1,
                             initial_fields=torch.from_numpy(np.array(init)))
    for got, want in zip(tl, jl):
        close(got, want)
    close(tl.total, jl.total)
    assert float(tl.total) > 0.0 and float(tl.initial) > 0.0


@pytest.mark.parametrize("name,criteria", [("BURGERS", "value"),
                                           ("NAVIER_STOKES", "vorticity"),
                                           ("WAVE", "value")])
def test_adaptive_split_matches_jax(name, criteria):
    jcfg, tcfg = configs(name, split_criteria=criteria)
    prev = perturbed_state(jcfg, 5)
    rng = np.random.default_rng(6)
    act = np.asarray(prev.interior)[:, None]
    # The state a step later: moved values and means; some values tiny so
    # the prune has work.
    u = prev.u + rng.normal(size=prev.u.shape) * 0.05 * act
    u = np.where(rng.uniform(size=(CAP, 1)) < 0.1, 1e-4, u)
    now = prev._replace(u=jnp.asarray(u), means=prev.means
                        + rng.normal(size=prev.means.shape) * 0.01 * act)
    want = jmodel.adaptive_split(jcfg, now, prev)
    got = tmodel.adaptive_split(tcfg, to_torch(now), to_torch(prev))
    for f in JState._fields:
        close(getattr(got, f), getattr(want, f))
    assert int(got.active.sum()) != int(np.asarray(now.active).sum())


def test_adaptive_split_rejects_bad_criteria():
    _, tcfg = configs("BURGERS")
    st = tmodel.make_initial_state(tcfg)
    with pytest.raises(ValueError, match="unknown split_criteria"):
        tmodel.adaptive_split(tcfg._replace(split_criteria="x"), st, st)
    with pytest.raises(ValueError, match="two-channel"):
        tmodel.adaptive_split(tcfg._replace(split_criteria="vorticity"), st,
                              st)


def test_peak_vorticity_contribution():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(9, 2, 2))
    conics = a @ np.swapaxes(a, -1, -2) + np.eye(2)
    u = rng.normal(size=(9, 2))
    close(tmodel.peak_vorticity_contribution(torch.from_numpy(conics),
                                             torch.from_numpy(u)),
          jmodel.peak_vorticity_contribution(jnp.asarray(conics),
                                             jnp.asarray(u)))


@pytest.mark.parametrize("name,n", [("BURGERS", 5), ("WAVE", 7),
                                    ("NAVIER_STOKES", 4), ("BURGERS", 9)])
def test_grid_state_dynamic_and_ic_noise(name, n):
    jcfg, tcfg = configs(name)
    n_max = 9
    jgrid = jmodel.grid_state_dynamic(jcfg, n, n_max)
    tgrid = tmodel.grid_state_dynamic(tcfg, n, n_max)
    for f in JState._fields:
        close(getattr(tgrid, f), getattr(jgrid, f), rtol=1e-12)
    assert int(tgrid.interior.sum()) == n * n
    # JAX's own draws, injected into the port's noise.
    ks = jax.random.split(jax.random.PRNGKey(n), 8)
    draws = [jax.random.normal(ks[i], getattr(jgrid, f).shape, jnp.float64)
             for i, f in enumerate(("means", "u", "scaling", "transforms"))]
    want = jmodel._apply_ic_noise(jcfg, ks, jgrid)
    got = tmodel._apply_ic_noise(tcfg, tgrid, [torch.from_numpy(np.array(x))
                                               for x in draws])
    for f in JState._fields:
        close(getattr(got, f), getattr(want, f), rtol=1e-12)


def test_randomize_state_dynamic_structure():
    _, tcfg = configs("BURGERS")
    gen = torch.Generator().manual_seed(0)
    st = tmodel.randomize_state_dynamic(tcfg, gen, 8, 9)
    base = tmodel.grid_state_dynamic(tcfg, 8, 9)
    assert torch.equal(st.active, base.active)
    assert int(st.interior.sum()) == 64 and int(st.boundary.sum()) == 100
    b, i, free = st.boundary, st.interior, ~st.active
    # Boundary and free slots are untouched; interior means stay inside.
    for f in ("means", "scaling", "transforms", "u"):
        assert torch.equal(getattr(st, f)[b | free], getattr(base, f)[b | free])
    assert st.means[i].abs().max() < 0.95
    assert not torch.equal(st.u[i], base.u[i])
    assert (st.scaling[i] > 0).all() and st.transforms[i].abs().max() < 1.0
    again = tmodel.randomize_state_dynamic(
        tcfg, torch.Generator().manual_seed(0), 8, 9)
    assert all(torch.equal(a, b) for a, b in zip(st, again))


def test_randomize_test_problem():
    _, tcfg = configs("TEST", nx=10)
    base = tmodel.make_initial_state(tcfg)
    st = tmodel._randomize_test(tcfg, [0.9, 0.5, 0.2, 0.3, 0.75])
    i = st.interior
    # Edge draw (0.9 > 0.75), lower edge (0.2 <= 0.5): y = -(0.9 + 0.05).
    np.testing.assert_allclose(st.means[i, 1].numpy(), -0.95)
    np.testing.assert_allclose(st.u[i, 0].numpy(), 0.5)
    assert torch.equal(st.means[i, 0], base.means[i, 0])
    assert torch.equal(st.means[~i], base.means[~i])
    mid = tmodel._randomize_test(tcfg, [0.1, 0.5, 0.9, 0.25, 0.0])
    np.testing.assert_allclose(mid.means[i, 1].numpy(), -0.45)
    np.testing.assert_allclose(mid.u[i, 0].numpy(), -1.0)
    drawn = tmodel.randomize_state_dynamic(
        tcfg, torch.Generator().manual_seed(3), 0, 0)
    y = drawn.means[drawn.interior, 1]
    assert torch.all(y == y[0]) and float(y[0].abs()) <= 1.0
