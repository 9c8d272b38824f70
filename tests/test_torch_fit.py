"""Parity of the port's fit-to-target initializer (``pigs_tpu_torch.train.
fit``) with ``pigs_tpu.train.fit`` on the CPU.

At small sizes (nx 4, capacity 24, 48 samples, a few iterations a block),
in float64, against the JAX functions of the same name:

* ``_init``, ``_concrete``, ``_render`` (the value and the curl with its
  divergence, periodic or not, d = 1 and 2) and the three targets:
  norm-relative <= 1e-12;
* ``_fit_block`` on JAX's draws (split from the block's key as JAX splits
  it): the curl fit on the torus, a value fit with tanh means and the d=1
  path; parameters, the four Adams' moments and counts, the mean loss and
  the last raw_means gradient <= 1e-9;
* ``_eig_split``: masks equal, parameters and moments <= 1e-12, the fresh
  rows' moments zero, each group's count kept;
* ``fit`` with a split every 2 blocks and the jitter every 3 on JAX's key
  sequence (block draws and the jitter's normals injected), against JAX's
  ``fit``; and the cadence of both on a stubbed block.

At full width, from the exported fixture (artifacts/fit_torch.npz,
``scripts/export_torch_fixture.py --kind fit``): the curl fit's block run
by the port in float32 on the CPU against the JAX float64 block, within
``chip_smoke.py``'s limits for the card (twice this run's errors with two
threads), and ``_eig_split`` at capacity 4096 with masks equal to JAX's.
"""

import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.train import fit as jfit
from pigs_tpu_torch import convert
from pigs_tpu_torch.ops import mixture_kernel as mk
from pigs_tpu_torch.train import fit as tfit
from pigs_tpu_torch.train import ns_data as tns

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "artifacts" / "fit_torch.npz"
NS_DATA = ROOT / "artifacts" / "ns_data_8traj.npz"
TOL = 1e-12
BLOCK_TOL = 1e-9


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exporter():
    return load_module("export_torch_fixture",
                       ROOT / "scripts" / "export_torch_fixture.py")


@pytest.fixture(scope="module")
def smoke():
    return load_module("chip_smoke", ROOT / "chip_smoke.py")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / (denom if denom else 1.0))


def configs(**kw):
    base = dict(nx=4, capacity=24, n_samples=48, block_iters=4, iters=8)
    base.update(kw)
    return (jfit.FitConfig(dtype=jnp.float64, **base),
            tfit.FitConfig(dtype=torch.float64, **base))


def random_params(jcfg, seed):
    """Init params perturbed by numpy draws, as numpy arrays, and the
    active mask."""
    rng = np.random.default_rng(seed)
    params, active = jfit._init(jcfg)
    p = [np.array(x) for x in params]
    p[0] = p[0] + 0.05 * rng.standard_normal(p[0].shape)
    p[1] = 0.3 * rng.standard_normal(p[1].shape)
    p[2] = p[2] + 2.0 + 0.3 * rng.standard_normal(p[2].shape)
    p[3] = 0.3 * rng.standard_normal(p[3].shape)
    return p, np.asarray(active)


def jparams(p):
    return jfit.RawParams(*(jnp.asarray(x) for x in p))


def tparams(p, grad=False):
    return tfit.RawParams(*(torch.tensor(x).requires_grad_(grad) for x in p))


def test_fit_config_defaults_match_jax():
    j, t = jfit.FitConfig(), tfit.FitConfig()
    for f in tfit.FitConfig._fields:
        if f != "dtype":
            assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.float32 and t.c == 1
    assert t._replace(curl=True).c == 2


@pytest.mark.parametrize("d,curl", [(1, False), (2, False), (2, True)])
def test_init_matches_jax(d, curl):
    jcfg, tcfg = configs(d=d, curl=curl)
    jp, ja = jfit._init(jcfg)
    tp, ta = tfit._init(tcfg)
    assert np.array_equal(np.asarray(ja), ta.numpy())
    for a, b in zip(tp, jp):
        assert a.shape == b.shape and a.dtype == torch.float64
        assert rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("d,tanh_means", [(1, True), (2, True), (2, False)])
def test_concrete_matches_jax(d, tanh_means):
    jcfg, tcfg = configs(d=d, tanh_means=tanh_means)
    p, _ = random_params(jcfg, 1)
    for a, b in zip(tfit._concrete(tcfg, tparams(p)),
                    jfit._concrete(jcfg, jparams(p))):
        assert a.shape == b.shape
        assert rel(a.numpy(), b) <= TOL


RENDER_CASES = {
    "value": dict(),
    "value-periodic": dict(periodic=True, tanh_means=False),
    "curl": dict(curl=True, tanh_means=False),
    "curl-periodic": dict(curl=True, periodic=True, tanh_means=False),
    "d1-value": dict(d=1),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_matches_jax(case):
    """The value, or the curl d(u_y)/dx - d(u_x)/dy with the divergence
    (the port's ux is (m, d, c) as JAX's), on the torus or not."""
    jcfg, tcfg = configs(**RENDER_CASES[case])
    p, active = random_params(jcfg, 2)
    x = np.random.default_rng(3).uniform(-1.2, 1.2, (60, jcfg.d))
    want = jfit._render(jcfg, jparams(p), jnp.asarray(active), jnp.asarray(x))
    got = tfit._render(tcfg, tparams(p), torch.tensor(active), torch.tensor(x))
    assert (got[1] is None) == (want[1] is None) == (not jcfg.curl)
    for a, b in zip(got, want):
        if b is not None:
            assert a.shape == b.shape
            assert rel(a.numpy(), b) <= TOL


def test_targets_match_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.2, 1.2, (200, 2))
    # Pixel edges and the corners, where truncation and clipping decide.
    x[:4] = [[-1.0, -1.0], [1.0, 1.0], [-1.0 + 1e-12, 0.999], [-1.01, 0.0]]
    image = rng.standard_normal((16, 16))
    jcfg, tcfg = configs()
    for jt, tt in ((jfit.gaussian_pair_target(jcfg),
                    tfit.gaussian_pair_target(tcfg)),
                   (jfit.sinusoid_target(), tfit.sinusoid_target()),
                   (jfit.image_target(jnp.asarray(image)),
                    tfit.image_target(torch.tensor(image)))):
        assert rel(tt(torch.tensor(x)).numpy(), jt(jnp.asarray(x))) <= TOL


def d1_targets():
    return (lambda s: jnp.exp(-4.0 * s[:, 0] ** 2),
            lambda s: torch.exp(-4.0 * s[:, 0] ** 2))


BLOCK_CASES = {
    "curl-periodic": dict(curl=True, periodic=True, tanh_means=False),
    "value-tanh": dict(),
    "d1-value": dict(d=1, nx=6, capacity=10),
}


def block_targets(case, jcfg, tcfg):
    if case == "curl-periodic":
        image = np.random.default_rng(5).standard_normal((16, 16))
        return (jfit.image_target(jnp.asarray(image)),
                tfit.image_target(torch.tensor(image)))
    if case == "d1-value":
        return d1_targets()
    return jfit.gaussian_pair_target(jcfg), tfit.gaussian_pair_target(tcfg)


def state_pair(jcfg, p):
    """The JAX multi_transform state of ``p`` after 3 Adam steps on fixed
    numpy gradients (so every moment and count is non-trivial), and the
    port's copy of it."""
    opt = jfit._make_optimizer(jcfg)
    state = opt.init(jparams(p))
    rng = np.random.default_rng(6)
    for _ in range(3):
        g = jfit.RawParams(*(jnp.asarray(0.1 * rng.standard_normal(x.shape))
                             for x in p))
        _, state = opt.update(g, state)
    return state


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_fit_block_matches_jax_on_its_draws(case, exporter):
    jcfg, tcfg = configs(**BLOCK_CASES[case])
    p, active = random_params(jcfg, 7)
    jstate = state_pair(jcfg, p)
    jt, tt = block_targets(case, jcfg, tcfg)
    key = jax.random.PRNGKey(8)
    jp, jstate, jloss, jgrad = jfit._fit_block(jcfg, jt, jparams(p), jstate,
                                               jnp.asarray(active), key)
    draws = torch.tensor(exporter.jax_fit_draws(jcfg, key))
    tstate = convert.fit_adam_from_optax(
        exporter.fit_adam_groups(state_pair(jcfg, p)))
    tp, tstate, tloss, tgrad = tfit._fit_block(
        tcfg, tt, tparams(p, grad=True), tstate, torch.tensor(active), draws)
    assert rel(tloss.item(), float(jloss)) <= BLOCK_TOL
    assert rel(tgrad.numpy(), jgrad) <= BLOCK_TOL
    for a, b in zip(tp, jp):
        assert rel(a.detach().numpy(), b) <= BLOCK_TOL
    if jcfg.periodic:
        assert bool((tp.raw_means >= -1).all() and (tp.raw_means < 1).all())
    for s, (mu, nu, count) in zip(tstate, exporter.fit_adam_groups(jstate)):
        assert int(s.count) == int(count) == 3 + jcfg.block_iters
        assert rel(s.mu[0].numpy(), mu) <= BLOCK_TOL
        assert rel(s.nu[0].numpy(), nu) <= BLOCK_TOL


def test_fit_block_runs_one_forward_and_one_gauss_backward_an_iteration():
    """One K1 and one K2 an iteration on the card (the twins here), never
    the sample-side backward (K3)."""
    _, tcfg = configs(curl=True, periodic=True, tanh_means=False)
    params, active = tfit._init(tcfg)
    params = tfit.RawParams(*(x.requires_grad_() for x in params))
    calls = {"fwd": 0, "gauss": 0, "sample": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    draws = tfit.block_draws(tcfg, torch.Generator().manual_seed(0))
    assert draws.shape == (tcfg.block_iters, tcfg.n_samples, 2)
    with mock.patch.object(mk, "mixture_forward_plain",
                           spy("fwd", mk.mixture_forward_plain)), \
            mock.patch.object(mk, "mixture_backward_gauss",
                              spy("gauss", mk.mixture_backward_gauss)), \
            mock.patch.object(mk, "mixture_backward_sample",
                              spy("sample", mk.mixture_backward_sample)):
        tfit._fit_block(tcfg, tfit.sinusoid_target(), params,
                        tfit._opt_init(params), active, draws)
    n = tcfg.block_iters
    assert calls == {"fwd": n, "gauss": n, "sample": 0}


def split_inputs(jcfg, seed):
    """A state in which the split both drops and splits, with non-zero
    Adam moments."""
    rng = np.random.default_rng(seed)
    p, active = random_params(jcfg, seed)
    p[2] = p[2] - 2.0                      # variances exp(-5): kept
    p[1][::5] *= 1e-3                      # dropped: |v| < 0.01
    p[2][7] = 0.0                          # dropped: sum(var) >= 0.2
    grad = 1e-4 * rng.standard_normal(p[0].shape)
    grad[[2, 3, 9, 11]] *= 100.0           # split
    return p, active, grad, state_pair(jcfg, p)


@pytest.mark.parametrize("d", [1, 2])
def test_eig_split_matches_jax(d, exporter):
    jcfg, tcfg = configs(d=d, nx=16 if d == 1 else 4)
    p, active, grad, jstate = split_inputs(jcfg, 9)
    want_p, want_state, want_a = jfit._eig_split(
        jcfg, jparams(p), jstate, jnp.asarray(active), jnp.asarray(grad))
    tstate = convert.fit_adam_from_optax(exporter.fit_adam_groups(jstate))
    got_p, got_state, got_a = tfit._eig_split(
        tcfg, tparams(p), tstate, torch.tensor(active), torch.tensor(grad))
    want_a = np.asarray(want_a)
    assert np.array_equal(got_a.numpy(), want_a)
    keep = ((np.linalg.norm(p[1], axis=-1) > 0.01)
            & (np.exp(p[2]).sum(-1) < 0.2) & active)
    # Dropped, and children written (into dropped slots first).
    assert (active & ~keep).any() and want_a.sum() > keep.sum()
    for a, b in zip(got_p, want_p):
        assert rel(a.numpy(), b) <= TOL
    fresh = (want_a & ~keep) | (active & ~keep)
    for s, (mu, nu, count) in zip(got_state,
                                  exporter.fit_adam_groups(want_state)):
        assert int(s.count) == int(count) == 3
        assert rel(s.mu[0].numpy(), mu) <= TOL
        assert rel(s.nu[0].numpy(), nu) <= TOL
        assert bool((s.mu[0][fresh] == 0).all() and (s.nu[0][fresh] == 0).all())


def test_jitter_moves_means_and_zeroes_values():
    _, tcfg = configs()
    p, _ = random_params(configs()[0], 10)
    normals = torch.tensor(np.random.default_rng(11).standard_normal(
        p[0].shape) * 2.0)
    out = tfit._jitter(tparams(p), normals)
    want = p[0] + np.clip(normals.numpy(), -1, 1) * 0.01
    assert rel(out.raw_means.numpy(), want) <= TOL
    assert bool((out.values == 0).all())
    assert np.array_equal(out.raw_scaling.numpy(), p[2])


FIT_KW = dict(block_iters=3, iters=12, split_every_blocks=2,
              jitter_every_blocks=3, lr_values=5e-2)


def jax_key_sequence(exporter, jcfg, seed):
    """What ``pigs_tpu.train.fit.fit`` draws from PRNGKey(seed): each
    block's uniforms and, after the blocks the jitter follows, its
    normals, in the port's layouts."""
    key = jax.random.PRNGKey(seed)
    blocks, normals = [], []
    for b in range(jcfg.iters // jcfg.block_iters):
        key, sub = jax.random.split(key)
        blocks.append(torch.tensor(exporter.jax_fit_draws(jcfg, sub)))
        if (b + 1) % jcfg.jitter_every_blocks == 0:
            key, sub = jax.random.split(key)
            normals.append(torch.tensor(np.asarray(jax.random.normal(
                sub, (jcfg.capacity, jcfg.d), jcfg.dtype))))
    return blocks, normals


def test_fit_matches_jax_with_split_and_jitter(exporter):
    jcfg, tcfg = configs(**FIT_KW)
    jt, tt = jfit.gaussian_pair_target(jcfg), tfit.gaussian_pair_target(tcfg)
    jp, ja, jlosses = jfit.fit(jcfg, jt, jax.random.PRNGKey(12))
    blocks, normals = jax_key_sequence(exporter, jcfg, 12)
    with mock.patch.object(tfit, "block_draws",
                           side_effect=lambda *a, **k: blocks.pop(0)), \
            mock.patch.object(tfit, "jitter_draws",
                              side_effect=lambda *a, **k: normals.pop(0)):
        tp, ta, tlosses = tfit.fit(tcfg, tt, torch.Generator())
    assert not blocks and not normals
    ja = np.asarray(ja)
    assert np.array_equal(ta.numpy(), ja)
    assert ja.sum() != jcfg.nx * jcfg.nx       # the split changed the mask
    assert len(tlosses) == len(jlosses) == 4
    assert rel(tlosses, jlosses) <= BLOCK_TOL
    for a, b in zip(tp, jp):
        assert not a.requires_grad
        assert rel(a.numpy(), b) <= BLOCK_TOL


def test_fit_cadence():
    """Blocks = iters // block_iters; the split after every
    ``split_every_blocks``-th block, the jitter after every
    ``jitter_every_blocks``-th, one loss a block."""
    _, tcfg = configs(block_iters=2, iters=13, split_every_blocks=2,
                      jitter_every_blocks=3)
    seen = []

    def block(cfg, target, params, opt, active, draws):
        seen.append(("block", draws.shape[0]))
        return params, opt, torch.tensor(float(len(seen))), params.raw_means

    def split(cfg, params, opt, active, grad):
        seen.append("split")
        return params, opt, active

    def jitter(params, normals):
        seen.append(("jitter", tuple(normals.shape)))
        return params
    with mock.patch.object(tfit, "_fit_block", block), \
            mock.patch.object(tfit, "_eig_split", split), \
            mock.patch.object(tfit, "_jitter", jitter):
        _, _, losses = tfit.fit(tcfg, None, torch.Generator().manual_seed(0))
    assert len(losses) == 6
    b, j = ("block", 2), ("jitter", (24, 2))
    assert seen == [b, b, "split", b, j, b, "split", b, b, "split", j]


def test_fit_params_and_adam_from_jax(exporter):
    jcfg, _ = configs(curl=True)
    p, _ = random_params(jcfg, 13)
    tp = convert.fit_params_from_jax(jparams(p), dtype=torch.float32)
    assert isinstance(tp, tfit.RawParams)
    assert all(a.dtype == torch.float32 and a.shape == b.shape
               for a, b in zip(tp, p))
    state = convert.fit_adam_from_optax(
        exporter.fit_adam_groups(state_pair(jcfg, p)), dtype=torch.float32)
    assert isinstance(state, tfit.FitOptState)
    assert [s.mu[0].shape for s in state] == [x.shape for x in p]
    assert all(s.count.dtype == torch.int32 and int(s.count) == 3
               for s in state)


# ------------------------------------------------------ the fixture ----


@pytest.fixture(scope="module")
def fixture():
    return convert.load_fit_fixture(str(FIXTURE))


def test_fixture_recipe_is_the_curl_fit(fixture):
    cfg, split_cfg, data = fixture
    want = tns.fit_config()._replace(block_iters=cfg.block_iters)
    assert cfg == want
    assert split_cfg == tfit.FitConfig(block_iters=20)
    assert int(data["config_seed"]) == 1 + int(data["config_traj"]) == 8
    with np.load(NS_DATA) as z:
        assert np.array_equal(data["frame"], z["frames"][7, :, :, 0])
    assert data["draws"].shape == (cfg.block_iters, 1024, 2)
    assert data["noise"].shape == (8, 128, 128)
    assert FIXTURE.stat().st_size <= 2 * 2 ** 20


def test_fixture_block_float32_within_chip_tolerances(fixture, smoke):
    cfg, _, data = fixture
    # Two threads, as the no-MLP fixture test: the float32 sums, whose
    # order follows the thread count, are then the same on every host.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        errs = smoke.fit_block_errors(cfg, data, torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    print("float32 plain curl-fit block vs JAX float64:", errs)
    for k, e in errs.items():
        assert e <= smoke.FIT_BLOCK_TOL[k], (k, e)


def test_fixture_split_masks_equal_jax(fixture, smoke):
    _, split_cfg, data = fixture
    same, zero, n_new = smoke.fit_split_check(split_cfg, data,
                                              torch.device("cpu"))
    assert same and zero and n_new > 0
