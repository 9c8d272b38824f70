"""The plain reference against the program's plain path (the dense oracle,
float64, on the CPU) at small sizes: the mixture, a timestep, a training
epoch with the split, and both rollouts."""

import numpy as np
import pytest
import torch

from portbench import common, traffic
from portbench.reference import pn as ref
from portbench.tests import tiny

F64 = torch.float64


def program(name):
    """The program's model in float64 on its plain path, and the cell."""
    from pigs_tpu_torch.convert import load_train_fixture
    c, overrides = tiny.cell(name)
    cfg, net, opt, _, _ = load_train_fixture(
        c.path(c.config["fixture"]["train"]), dtype=F64)
    cfg = cfg._replace(mixture_impl="plain", **(overrides or {}))
    net = net.double()
    opt = opt._replace(mu=[m.double() for m in opt.mu],
                       nu=[v.double() for v in opt.nu])
    return c, cfg, net, opt


def reference_params(c):
    data = common.load_arrays(c.path(c.config["fixture"]["train"]))
    params = {k: torch.as_tensor(v).to(F64)
              for k, v in common.subtree(data, "params").items()}
    return data, params, torch.as_tensor(data["frequencies"]).to(F64)


def inputs(c, seed=3):
    data = train_set = None
    if c.config["ic"]["kind"] == "stored_state":
        data = common.load_arrays(c.path(c.config["fixture"]["ns_data"]))
        train_set = traffic.trajectories(c.config, "train")
    return traffic.epoch_inputs(c.config, torch.Generator().manual_seed(seed),
                                c.config["recipe"]["n_samples"], F64, "cpu",
                                data, train_set), data


def mixture_state(s):
    from pigs_tpu_torch.models.state import MixtureState
    return MixtureState(**{k: s[k] for k in MixtureState._fields})


@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("period", [None, 2.0])
def test_mixture_matches_the_oracle(order, period):
    from pigs_tpu_torch.ops.oracle import eval_mixture_dense
    g = torch.Generator().manual_seed(order)
    n, m = 9, 13
    means = torch.rand((n, 2), generator=g, dtype=F64) * 2 - 1
    scaling = torch.rand((n, 2), generator=g, dtype=F64) * 0.1 + 0.01
    tf = torch.randn((n, 1), generator=g, dtype=F64)
    _, conic = ref.covariances(scaling, tf)
    values = torch.randn((n, 2), generator=g, dtype=F64)
    mask = torch.rand(n, generator=g) > 0.3
    x = torch.rand((m, 2), generator=g, dtype=F64) * 2 - 1
    got = ref.mixture(means, conic, values, x, order, mask, period, chunk=5)
    want = eval_mixture_dense(means, conic, values, x, order, mask, period)
    for key in ("u", "ux", "uxx", "uxxx")[:order + 1]:
        np.testing.assert_allclose(got[key].numpy(),
                                   getattr(want, key).numpy(), atol=1e-12)


@pytest.mark.parametrize("name", ["burgers-train", "ns-train"])
def test_forward_step_matches(name):
    from pigs_tpu_torch.models.model import forward_step
    c, cfg, net, _ = program(name)
    _, params, freqs = reference_params(c)
    inp, _ = inputs(c)
    model = ref.Model(c.config["problem"], c.config["capacity"])
    with torch.no_grad():
        want, wd = forward_step(cfg, net, mixture_state(inp["state"]))
        got, gd = ref.forward_step(model, params, freqs, inp["state"],
                                   with_grad=False)
    for key in ("means", "scaling", "transforms", "u"):
        np.testing.assert_allclose(got[key].numpy(),
                                   getattr(want, key).numpy(), atol=1e-11)
    np.testing.assert_allclose(gd[4].numpy(), wd.head_magnitudes.numpy(),
                               rtol=1e-11)


@pytest.mark.parametrize("name", ["burgers-train", "ns-train"])
def test_training_epoch_with_split_matches(name):
    from pigs_tpu_torch.models.model import sample_fields
    from pigs_tpu_torch.train.pn import pn_epoch
    c, cfg, net, opt = program(name)
    data, params, freqs = reference_params(c)
    inp, ns = inputs(c)
    recipe = dict(c.config["recipe"], base_lr=1e-3)
    n = 3
    targets = None
    if ns is not None:
        targets = traffic.recon_targets(ns, inp["trajectory"], inp["samples"],
                                        n)
    state = mixture_state(inp["state"])
    with torch.no_grad():
        prev = sample_fields(cfg, state, inp["samples"], inp["bc_samples"])
    res = pn_epoch(cfg, net, opt, state, prev, inp["samples"], inp["times"],
                   inp["bc_samples"], recipe["base_lr"], recipe["epsilon"],
                   recipe["dt"], n, loss_weight_floor=recipe[
                       "loss_weight_floor"], do_split=True,
                   clip_norm=recipe["clip_norm"], skip_nonfinite=True,
                   recon_targets=targets)
    names = sorted(params)
    ropt = ([torch.as_tensor(common.subtree(data, "adam_mu")[k]).to(F64)
             for k in names],
            [torch.as_tensor(common.subtree(data, "adam_nu")[k]).to(F64)
             for k in names], int(data["adam_count"]))
    new, _, totals, _ = ref.epoch(model=ref.Model(c.config["problem"],
                                                  c.config["capacity"]),
                                  params=params, opt=ropt, freqs=freqs,
                                  names=names, state=inp["state"],
                                  samples=inp["samples"],
                                  time_samples=inp["times"],
                                  bc_samples=inp["bc_samples"], n_steps=n,
                                  recipe=recipe, epoch_index=10 ** 6,
                                  recon_targets=targets)
    np.testing.assert_allclose(np.asarray(totals),
                               res.per_step[:, :5].numpy(), rtol=1e-9)
    got = {common.flax_name(k): p.detach()
           for k, p in net.named_parameters()}
    for k in names:
        want = new[k].T if k.endswith("/kernel") else new[k]
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), atol=1e-11,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["burgers-rollout", "ns-rollout"])
def test_rollout_matches(name):
    from pigs_tpu_torch.convert import load_fixture
    from pigs_tpu_torch.train.pn import rollout_frames, rollout_vorticity
    c, overrides = tiny.cell(name)
    cfg, net, data = load_fixture(c.path(c.config["fixture"]["serve"]))
    cfg = cfg._replace(dtype=F64, mixture_impl="plain", **(overrides or {}))
    net = net.double()
    params = {k: torch.as_tensor(v).to(F64)
              for k, v in common.subtree(data_all(c), "params").items()}
    freqs = torch.as_tensor(data["frequencies"]).to(F64)
    ns = None
    if c.config["ic"]["kind"] == "stored_state":
        ns = common.load_arrays(c.path(c.config["fixture"]["ns_data"]))
    ics = traffic.rollout_ics(c.config, c.traffic, 4, 2, "cpu", ns)
    if ns is None:
        s = {k: ics[k][1] for k in ("means", "scaling", "transforms", "u",
                                    "active", "boundary")}
    else:
        s = traffic.stored_state(ns, int(ics["trajectory"][1]),
                                 c.config["capacity"], torch.float32, "cpu")
    s = {k: v.to(F64) if v.is_floating_point() else v for k, v in s.items()}
    steps = 4
    if c.config["rollout"]["kind"] == "frames":
        want = rollout_frames(cfg, net, mixture_state(s), steps, 16, 0.1)
    else:
        want = rollout_vorticity(cfg, net, mixture_state(s), steps, 16)
    got = ref.rollout(ref.Model(c.config["problem"], c.config["capacity"]),
                      params, freqs, s, steps, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-11)


def data_all(c):
    return common.load_arrays(c.path(c.config["fixture"]["serve"]))
