"""Parity of the port's dynamics network with the flax one (float64, CPU).

A flax network is initialised at random, its parameters go through
``convert.params_from_flax`` into the torch network, and both run on the
same numpy inputs.  Tolerance: rtol 1e-10 of the output's scale -- float64
on both sides through a few dozen layers and two aggregation heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.models.dynamics import DynamicsNetwork as JNet
from pigs_tpu.ops.aggregate import neighbor_mask as j_neighbor_mask
from pigs_tpu_torch import convert
from pigs_tpu_torch.models.dynamics import DynamicsNetwork, default_frequencies

RTOL = 1e-10


def flatten(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_frequencies(d):
    """What the flax module draws in this process (x64 on: float64 bits)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(42),
                                      ((25 - 1) // d // 2,)) * 10.0)


def inputs(seed, n, c, d, p):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, d))
    diag = np.exp(rng.normal(size=(n, d)) * 0.3 - 3.0)
    cov = np.zeros((n, d, d))
    for a in range(d):
        cov[:, a, a] = diag[:, a]
    cov[:, 0, 1] = cov[:, 1, 0] = 0.3 * np.sqrt(diag[:, 0] * diag[:, 1])
    active = np.arange(n) < n - 5
    return [means, cov, rng.normal(size=(n, c)),
            (np.arange(n) < 6).astype(np.float64), rng.normal(size=(n, c)),
            rng.normal(size=(n, d * c)), rng.normal(size=(n, d * c)),
            rng.normal(size=(n, p)), active]


@pytest.mark.parametrize("c,p,period,width", [(1, 1, None, 1), (2, 1, 2.0, 1),
                                              (2, 2, None, 1), (1, 1, None, 2)])
def test_deltas_match_flax(c, p, period, width):
    d, n = 2, 30
    args = inputs(c + p + width, n, c, d, p)
    jargs = [jnp.asarray(a) for a in args]
    nbr = j_neighbor_mask(jargs[0], jargs[1], active=jargs[8], sigma_cut=6.0,
                          period=period)
    jnet = JNet(c=c, d=d, pde_size=p, width_mult=width)
    params = jnet.init(jax.random.PRNGKey(c + 10 * p), *jargs, nbr, period)
    want = jnet.apply(params, *jargs, nbr, period)

    net = DynamicsNetwork(c=c, d=d, pde_size=p, width_mult=width,
                          frequencies=torch.from_numpy(jax_frequencies(d)))
    net = net.double()
    net.load_state_dict(convert.params_from_flax(flatten(params)))
    targs = [torch.from_numpy(a) for a in args]
    got = net(*targs, torch.from_numpy(np.array(nbr)), period)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=RTOL * max(np.abs(w).max(), 1.0))
    # Inactive slots get no delta.
    assert (got.dmeans[n - 5:] == 0).all() and (got.du[n - 5:] == 0).all()


@pytest.mark.parametrize("d", [1, 2])
def test_frequencies_are_jax_constants(d):
    want = jax.random.normal(jax.random.PRNGKey(42), ((25 - 1) // d // 2,),
                             dtype=jnp.float32) * 10.0
    np.testing.assert_array_equal(default_frequencies(d).numpy(),
                                  np.asarray(want))
    net = DynamicsNetwork(c=1, d=2, pde_size=1)
    np.testing.assert_array_equal(net.frequencies.numpy(),
                                  default_frequencies(2).numpy())
    # A constant, not a parameter: not in the state dict, never trained.
    assert "frequencies" not in net.state_dict()


def test_name_map_both_directions():
    args = [jnp.asarray(a) for a in inputs(0, 12, 1, 2, 1)]
    nbr = j_neighbor_mask(args[0], args[1], active=args[8])
    flat = flatten(JNet(c=1, d=2, pde_size=1).init(jax.random.PRNGKey(0),
                                                   *args, nbr))
    torch_keys = set(DynamicsNetwork(c=1, d=2, pde_size=1).state_dict())
    assert len(flat) == 92 and {convert.flax_to_torch_name(k)
                                for k in flat} == torch_keys
    for key in flat:
        assert convert.torch_to_flax_name(convert.flax_to_torch_name(key)) == key
    for key in torch_keys:
        assert convert.flax_to_torch_name(convert.torch_to_flax_name(key)) == key
    back = convert.params_to_flax(convert.params_from_flax(flat))
    assert back.keys() == flat.keys()
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    state = convert.params_from_flax(flat)
    assert state["query.0.layers.1.weight"].shape == (16, 16)
    np.testing.assert_array_equal(
        state["input_transform.latent_net.layers.0.weight"].numpy(),
        flat["params/InputTransform_0/latent_net/Dense_0/kernel"].T)
    np.testing.assert_array_equal(state["transform_1"].numpy(),
                                  flat["params/transform_1"])
    with pytest.raises(KeyError):
        convert.flax_to_torch_name("params/Conv_0/kernel")


def test_seeded_init_is_flax_like_and_reproducible():
    nets = [DynamicsNetwork(c=1, d=2, pde_size=1,
                            generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    a, b = (n.state_dict() for n in nets)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for key, value in a.items():
        if key.endswith(".bias"):
            assert (value == 0).all()
        elif key.endswith(".weight"):
            std = (1.0 / value.shape[1]) ** 0.5 / 0.87962566103423978
            assert value.abs().max() <= 2.0 * std + 1e-6
        else:  # raw attention params, U[0, 2)
            assert value.min() >= 0.0 and value.max() < 2.0


@pytest.mark.parametrize("act", ["wave", "rbf"])
def test_activations_match_flax(act):
    """WaveAct and RBFAct: flax's initial values, then random parameters
    carried across, on the same inputs (rtol 1e-12)."""
    from pigs_tpu.models.dynamics import RBFAct as JRBF
    from pigs_tpu.models.dynamics import WaveAct as JWave
    from pigs_tpu_torch.models.dynamics import RBFAct, WaveAct
    rng = np.random.default_rng(7)
    x = rng.normal(size=(11, 4))
    jmod, tmod = (JWave(), WaveAct()) if act == "wave" else (JRBF(in_dim=4),
                                                            RBFAct(4))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    for name, value in params.items():
        np.testing.assert_array_equal(getattr(tmod, name).detach().numpy(),
                                      np.asarray(value))
    params = {k: jnp.asarray(rng.normal(size=v.shape)) for k, v in
              params.items()}
    tmod = tmod.double()
    with torch.no_grad():
        for name, value in params.items():
            getattr(tmod, name).copy_(torch.from_numpy(np.array(value)))
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-12)
