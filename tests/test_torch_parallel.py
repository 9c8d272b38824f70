"""The port's multi-process layer (pigs_tpu_torch.parallel) against the JAX
package's (float64, CPU).

One group of four gloo ranks, started once for the module, runs every case
(``_rank_main``); the JAX side runs on four of the virtual CPU devices that
tests/conftest.py sets up, on the same numpy inputs.  The ranks import only
torch, numpy and pigs_tpu_torch: this file imports JAX inside its tests
only, since a spawned rank imports the module that defines its function.

* ``eval_mixture_sharded`` on meshes (2, 2) and (1, 4), with and without a
  mask: the gathered fields within rtol 1e-12 of JAX's
  ``eval_mixture_sharded`` (the same sums, reordered).
* ``eval_mixture_ring`` on (2, 2) with a mask at order 2, against JAX's
  ``eval_mixture_ring`` at rtol 1e-12.
* The Gaussian gradients of the sharded and ring paths on (2, 2) and
  (1, 4), each rank differentiating its own data block's loss, against
  ``jax.grad`` of JAX's ``eval_mixture_dense`` with the global loss: rtol
  1e-10, atol 1e-12 (tests/test_parallel.py's bounds; conic gradients
  symmetrized, since the port's fused path puts the packed xy gradient on
  C[0, 1]).
* ``make_dp_train_step`` on (4, 1), three steps with SGD against JAX's
  ``make_dp_train_step`` (tests/test_parallel.py's setup): losses within
  rtol 1e-10, each step's parameter update within rtol 1e-9 (atol 1e-9 x
  the largest update; the port reaches ~3e-12), and the four ranks'
  parameters bitwise equal after every step.
* Sizes that do not divide an axis raise ``ValueError``; so does a mesh
  shape that does not lay out the ranks.
* In one process without a process group: the 1x1 mesh's paths equal
  ``eval_mixture`` and ``pn_step`` bitwise, and the launch helpers are
  no-ops (tests/test_sampling.py's checks of the JAX helpers).
"""

import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT_S = 300
LR, DT, CAP, NX, M_DP, DP_STEPS = 1e-3, 0.1, 192, 6, 64, 3

# name -> (path, mesh, n, m, order, masked, differentiated, seed)
CASES = {
    "sharded_2x2": ("sharded", (2, 2), 32, 64, 2, False, False, 0),
    "sharded_1x4_mask": ("sharded", (1, 4), 40, 24, 1, True, False, 1),
    "sharded_2x2_mask": ("sharded", (2, 2), 40, 32, 2, True, False, 4),
    "sharded_1x4": ("sharded", (1, 4), 24, 16, 2, False, False, 7),
    "ring_2x2_mask": ("ring", (2, 2), 40, 32, 2, True, False, 5),
    "grad_sharded_2x2": ("sharded", (2, 2), 32, 64, 1, False, True, 2),
    "grad_sharded_1x4": ("sharded", (1, 4), 24, 16, 1, True, True, 8),
    "grad_ring_2x2": ("ring", (2, 2), 32, 64, 1, True, True, 9),
    "grad_ring_1x4": ("ring", (1, 4), 24, 16, 1, False, True, 6),
}


def make_inputs(seed, n, m, masked, c=2):
    """Means, conics (the inverse of tests/test_parallel.py's covariance
    parametrization), values, samples and mask, as float64 numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, 2))
    s = np.exp(rng.normal(size=(n, 2)) * 0.3 - 2.0)
    off = np.tanh(rng.normal(size=n) * 0.5) * np.sqrt(s[:, 0] * s[:, 1])
    cov = np.stack([np.stack([s[:, 0], off], -1),
                    np.stack([off, s[:, 1]], -1)], -2)
    conics = np.linalg.inv(cov)
    conics = 0.5 * (conics + np.swapaxes(conics, -1, -2))
    values = rng.normal(size=(n, c))
    samples = rng.uniform(-1.0, 1.0, (m, 2))
    mask = (np.arange(n) % 5 != 0) if masked else np.ones(n, bool)
    return means, conics, values, samples, mask


def field_loss(fields):
    return sum((f ** 2).sum() for f in fields if f is not None)


# ---------------------------------------------------------------- ranks ----

def _sgd(params, grads, state, lr):
    """optax.sgd's update, in place."""
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)
    return state


def _dp_case(plan):
    from pigs_tpu_torch.convert import params_from_flax
    from pigs_tpu_torch.models.dynamics import default_frequencies
    from pigs_tpu_torch.models.model import (ModelConfig, make_initial_state,
                                             make_network, sample_fields)
    from pigs_tpu_torch.parallel.mesh import make_mesh
    from pigs_tpu_torch.parallel.sharded import gather
    from pigs_tpu_torch.parallel.train import make_dp_train_step
    from pigs_tpu_torch.pde import IntegrationRule, Problem
    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=NX, ny=NX, capacity=CAP, dtype=torch.float64)
    net = make_network(cfg, frequencies=default_frequencies(2))
    net.load_state_dict(params_from_flax(plan["params"]))
    samples, ts, bc = (torch.from_numpy(plan[k])
                       for k in ("samples", "time_samples", "bc"))
    state = make_initial_state(cfg)
    with torch.no_grad():
        prev = sample_fields(cfg, state, samples, bc)
    mesh = make_mesh((WORLD, 1))
    step = make_dp_train_step(mesh, cfg, net, opt=_sgd)
    losses, params = [], []
    for i in range(DP_STEPS):
        _, state, curr, loss = step(None, state, prev, samples, ts, bc, LR,
                                    i * DT, DT)
        prev = gather(mesh, curr)
        losses.append(float(loss))
        params.append(torch.cat([p.detach().flatten()
                                 for p in net.parameters()]).numpy())
    raised = False
    try:
        step(None, state, prev, samples[:M_DP - 2], ts[:M_DP - 2], bc, LR,
             0.0, DT)
    except ValueError:
        raised = True
    return {"losses": losses, "params": params, "m_raises": raised}


def _mixture_case(path, shape, n, m, order, masked, diff, seed):
    from pigs_tpu_torch.parallel.mesh import make_mesh
    from pigs_tpu_torch.parallel.sharded import (eval_mixture_ring,
                                                 eval_mixture_sharded, gather)
    fn = eval_mixture_sharded if path == "sharded" else eval_mixture_ring
    means, conics, values, samples, mask = (
        torch.from_numpy(x) for x in make_inputs(seed, n, m, masked))
    mesh = make_mesh(shape)
    leaves = [x.clone().requires_grad_(diff) for x in (means, conics, values)]
    out = fn(mesh, *leaves, samples, order=order, mask=mask)
    result = {"fields": [None if f is None else f.detach().numpy()
                         for f in gather(mesh, out)]}
    if diff:
        grads = torch.autograd.grad(field_loss(out), leaves)
        result["grads"] = [g.numpy() for g in grads]
    return result


def _rank_main(rank, store, out_dir, dp_plan):
    torch.set_num_threads(1)
    from pigs_tpu_torch.parallel.launch import (host_summary,
                                                initialize_distributed,
                                                is_multihost)
    from pigs_tpu_torch.parallel.mesh import make_mesh
    from pigs_tpu_torch.parallel.sharded import eval_mixture_sharded
    joined = initialize_distributed(f"file://{store}", WORLD, rank,
                                    device="cpu")
    result = {"joined": joined, "again": initialize_distributed(),
              "multihost": is_multihost(), "summary": host_summary()}
    for name, case in CASES.items():
        result[name] = _mixture_case(*case)
    result["dp"] = _dp_case(dp_plan)
    raises = {}
    try:
        make_mesh((3, 1))
    except ValueError:
        raises["mesh"] = True
    means, conics, values, samples, _ = (
        torch.from_numpy(x) for x in make_inputs(0, 30, 16, False))
    try:
        eval_mixture_sharded(make_mesh((1, 4)), means, conics, values,
                             samples)
    except ValueError:
        raises["n"] = True
    means, conics, values, samples, _ = (
        torch.from_numpy(x) for x in make_inputs(0, 32, 18, False))
    try:
        eval_mixture_sharded(make_mesh((4, 1)), means, conics, values,
                             samples)
    except ValueError:
        raises["m"] = True
    result["raises"] = raises
    torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


# ------------------------------------------------------------- JAX side ----

def _pinned_float32_normal():
    """The JAX network draws its frequencies with ``jax.random.normal`` and
    no dtype; pin the float32 draw, the numbers the port's
    ``default_frequencies`` hold."""
    from unittest import mock

    import jax
    import jax.numpy as jnp
    normal = jax.random.normal

    def f32_normal(key, shape=(), dtype=None):
        return normal(key, shape, jnp.float32 if dtype is None else dtype)
    return mock.patch.object(jax.random, "normal", f32_normal)


def _flatten(tree):
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_dp_reference():
    """JAX's params, inputs and three DP steps with SGD on a (4, 1) mesh of
    the CPU devices: ``(plan for the ranks, losses, flat params)``."""
    import jax
    import jax.numpy as jnp
    import optax

    from pigs_tpu.models import model as jmodel
    from pigs_tpu.parallel.mesh import make_mesh
    from pigs_tpu.parallel.train import make_dp_train_step
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train import pn as jpn
    cfg = jmodel.ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                                    nx=NX, ny=NX, capacity=CAP,
                                    dtype=jnp.float64)
    rng = np.random.default_rng(3)
    samples = rng.uniform(-1.0, 1.0, (M_DP, 2))
    ts = rng.uniform(0.0, 1.0, M_DP)
    bc = np.concatenate([
        np.stack([rng.choice([-1, 1], M_DP // 2)
                  * rng.uniform(1, 1.5, M_DP // 2),
                  rng.uniform(-1.5, 1.5, M_DP // 2)], -1),
        np.stack([rng.uniform(-1.5, 1.5, M_DP // 2),
                  rng.choice([-1, 1], M_DP // 2)
                  * rng.uniform(1, 1.5, M_DP // 2)], -1)])
    with _pinned_float32_normal():
        network, params, _, _ = jpn.init_training(
            cfg, jpn.TrainConfig(n_epochs=1, seed=7))
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                        params)
        opt = optax.inject_hyperparams(optax.sgd)(learning_rate=LR)
        opt_state = opt.init(params)
        state = jmodel.make_initial_state(cfg)
        prev = jmodel.sample_fields(cfg, state, jnp.asarray(samples),
                                    jnp.asarray(bc))
        step = make_dp_train_step(make_mesh((WORLD, 1),
                                            devices=jax.devices()[:WORLD]),
                                  cfg, network, opt)
        plan = {"params": _flatten(params), "samples": samples,
                "time_samples": ts, "bc": bc}
        losses, flat = [], []
        for i in range(DP_STEPS):
            params, opt_state, state, prev, loss = step(
                params, opt_state, state, prev, jnp.asarray(samples),
                jnp.asarray(ts), jnp.asarray(bc), jnp.asarray(LR),
                jnp.asarray(i * DT), DT)
            losses.append(float(loss))
            flat.append(_flatten(params))
    return plan, losses, flat


@pytest.fixture(scope="module")
def dp_reference():
    return jax_dp_reference()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, dp_reference):
    """Every rank's results: one group of four gloo ranks for the module."""
    import torch.multiprocessing as mp
    out = tmp_path_factory.mktemp("ranks")
    ctx = mp.spawn(_rank_main, args=(str(out / "store"), str(out),
                                     dp_reference[0]),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD} ranks did not finish in {TIMEOUT_S} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_inputs(case):
    import jax.numpy as jnp
    _, _, n, m, _, masked, _, seed = case
    return [jnp.asarray(x) for x in make_inputs(seed, n, m, masked)]


@pytest.mark.parametrize("name", [k for k, v in CASES.items() if not v[6]])
def test_fields_equal_jax(ranks, name):
    import jax
    from pigs_tpu.parallel.mesh import make_mesh
    from pigs_tpu.parallel.sharded import (eval_mixture_ring,
                                           eval_mixture_sharded)
    path, shape, _, _, order, _, _, _ = CASES[name]
    means, conics, values, samples, mask = _jax_inputs(CASES[name])
    fn = eval_mixture_sharded if path == "sharded" else eval_mixture_ring
    want = fn(make_mesh(shape, devices=jax.devices()[:WORLD]), means, conics,
              values, samples, order=order, mask=mask)
    for result in ranks:
        got = result[name]["fields"]
        assert [g is None for g in got] == [w is None for w in want]
        for g, w in zip(got, want):
            if w is not None:
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12,
                                           atol=1e-13)


@pytest.mark.parametrize("name", [k for k, v in CASES.items() if v[6]])
def test_gradients_equal_dense(ranks, name):
    import jax

    from pigs_tpu.ops.oracle import eval_mixture_dense
    _, _, _, _, order, _, _, _ = CASES[name]
    means, conics, values, samples, mask = _jax_inputs(CASES[name])

    def loss(means, conics, values):
        return field_loss(eval_mixture_dense(means, conics, values, samples,
                                             order=order, mask=mask))
    want = jax.grad(loss, argnums=(0, 1, 2))(means, conics, values)
    sym = lambda g: 0.5 * (g + np.swapaxes(g, -1, -2))
    for result in ranks:
        got = result[name]["grads"]
        for k, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            if k == 1:
                g, w = sym(g), sym(w)
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)


def test_dp_step_equals_jax(ranks, dp_reference):
    """Each step's parameter update (from the initial parameters) within
    rtol 1e-9 and atol 1e-9 x the step's largest update: the key heads'
    last biases have an exactly zero gradient (a constant added to every
    logit of a softmax), so both sides carry ~1e-21 of round-off there."""
    from pigs_tpu_torch.convert import params_from_flax
    from pigs_tpu_torch.models.dynamics import default_frequencies
    from pigs_tpu_torch.models.model import ModelConfig, make_network
    from pigs_tpu_torch.pde import IntegrationRule, Problem
    plan, losses, trees = dp_reference
    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=NX, ny=NX, capacity=CAP, dtype=torch.float64)
    net = make_network(cfg, frequencies=default_frequencies(2))

    def flat(tree):
        net.load_state_dict(params_from_flax(tree))
        return torch.cat([p.detach().flatten()
                          for p in net.parameters()]).numpy()
    start = flat(plan["params"])
    for i in range(DP_STEPS):
        want = flat(trees[i]) - start
        got = ranks[0]["dp"]["params"][i] - start
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())
        np.testing.assert_allclose(ranks[0]["dp"]["losses"][i], losses[i],
                                   rtol=1e-10)


def test_dp_replicas_stay_bitwise_equal(ranks):
    for i in range(DP_STEPS):
        for result in ranks[1:]:
            np.testing.assert_array_equal(result["dp"]["params"][i],
                                          ranks[0]["dp"]["params"][i])
            assert result["dp"]["losses"][i] == ranks[0]["dp"]["losses"][i]


def test_sizes_that_do_not_divide_raise(ranks):
    for result in ranks:
        assert result["raises"] == {"mesh": True, "n": True, "m": True}
        assert result["dp"]["m_raises"]


def test_launch_helpers_in_a_group(ranks):
    for rank, result in enumerate(ranks):
        assert result["joined"] and result["again"] and result["multihost"]
        assert result["summary"].startswith(f"process {rank}/{WORLD}, ")


# ---------------------------------------------------------- one process ----

def test_launch_single_process_noop():
    from pigs_tpu_torch.parallel.launch import (host_summary,
                                                initialize_distributed,
                                                is_multihost)
    assert initialize_distributed() is False
    assert is_multihost() is False
    assert "process 0/1" in host_summary()


def test_local_mesh_rejects_other_shapes():
    from pigs_tpu_torch.parallel.mesh import LocalMesh, make_mesh
    assert isinstance(make_mesh(), LocalMesh)
    with pytest.raises(ValueError, match="does not lay out"):
        make_mesh((2, 1))


@pytest.mark.parametrize("path", ["sharded", "ring"])
def test_local_mesh_equals_eval_mixture(path):
    from pigs_tpu_torch.ops.mixture import eval_mixture
    from pigs_tpu_torch.parallel.mesh import make_mesh
    from pigs_tpu_torch.parallel.sharded import (eval_mixture_ring,
                                                 eval_mixture_sharded)
    fn = eval_mixture_sharded if path == "sharded" else eval_mixture_ring
    means, conics, values, samples, mask = (
        torch.from_numpy(x) for x in make_inputs(3, 24, 20, True))
    a = [x.clone().requires_grad_() for x in (means, conics, values)]
    b = [x.clone().requires_grad_() for x in (means, conics, values)]
    got = fn(make_mesh(), *a, samples, order=2, mask=mask)
    want = eval_mixture(*b, samples, order=2, mask=mask)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
    for g, w in zip(torch.autograd.grad(field_loss(got), a),
                    torch.autograd.grad(field_loss(want), b)):
        assert torch.equal(g, w)


def test_local_mesh_dp_step_equals_pn_step():
    from pigs_tpu_torch.models.model import (ModelConfig, make_initial_state,
                                             sample_fields)
    from pigs_tpu_torch.parallel.mesh import make_mesh
    from pigs_tpu_torch.parallel.train import make_dp_train_step
    from pigs_tpu_torch.pde import IntegrationRule, Problem
    from pigs_tpu_torch.train.pn import TrainConfig, init_training, pn_step
    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=NX, ny=NX, capacity=CAP, dtype=torch.float64)
    rng = np.random.default_rng(5)
    samples = torch.from_numpy(rng.uniform(-1, 1, (32, 2)))
    ts = torch.from_numpy(rng.uniform(0, 1, 32))
    bc = torch.from_numpy(rng.uniform(-1.5, 1.5, (32, 2)))
    state = make_initial_state(cfg)
    lr = torch.full((), LR, dtype=torch.float64)
    results = []
    for use_dp in (True, False):
        net, opt = init_training(cfg, TrainConfig(seed=3))
        net = net.double()
        opt = opt._replace(mu=[m.double() for m in opt.mu],
                           nu=[v.double() for v in opt.nu])
        with torch.no_grad():
            prev = sample_fields(cfg, state, samples, bc)
        if use_dp:
            step = make_dp_train_step(make_mesh(), cfg, net)
            opt, new_state, curr, loss = step(opt, state, prev, samples, ts,
                                              bc, lr, 0.0, DT)
        else:
            opt, new_state, curr, _, loss, _ = pn_step(
                cfg, net, opt, state, prev, samples, ts, bc,
                torch.ones((), dtype=torch.float64), LR, 0.0, 0.0, DT)
        results.append((list(net.parameters()), opt, new_state, curr, loss))
    (p1, o1, s1, c1, l1), (p2, o2, s2, c2, l2) = results
    assert torch.equal(l1, l2)
    for a, b in zip(p1 + o1.mu + o1.nu + list(s1) + [c1.u, c1.ux, c1.bc_u],
                    p2 + o2.mu + o2.nu + list(s2) + [c2.u, c2.ux, c2.bc_u]):
        assert torch.equal(a, b)
    assert int(o1.count) == int(o2.count) == 1
