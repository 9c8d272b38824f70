"""Gradients of the port's mixture against the JAX package (CPU).

On CPU tensors ``eval_mixture`` runs the autograd Function whose backward
is the plain twin of K2 (Gaussian side) and K3 (sample side): the same
hand-derived adjoint the CUDA kernels compute.

* The Function against ``jax.grad`` through the JAX dense oracle in
  float64, for orders 0-3, c in {1, 2}, with and without mask and period,
  and d=1 through the d=2 embedding: rtol 1e-10 of each gradient's scale
  (the same sums in another order).  Conic gradients are compared
  symmetrized: the port routes the packed off-diagonal's gradient to
  C[0, 1] alone, the oracle treats C[0, 1] and C[1, 0] as independent; both
  give the same gradient to any symmetric parametrisation.
* The plain twins against ``_pallas_backward`` in interpret mode in
  float32, norm-relative 1e-5 (both sum in float32 in different orders).
* ``torch.autograd.gradcheck`` of the Function in float64 on a tiny case.
* A second-order gradient through the Function against the port's dense
  oracle in float64.

Inputs are made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pigs_tpu.ops.oracle import eval_mixture_dense as j_dense
from pigs_tpu.ops.pallas_mixture import _pallas_backward
from pigs_tpu_torch.gaussians import build_full_covariances
from pigs_tpu_torch.ops import mixture_kernel as mk
from pigs_tpu_torch.ops.mixture import eval_mixture
from pigs_tpu_torch.ops.oracle import eval_mixture_dense as t_dense

F64_RTOL = 1e-10
F32_NORM_REL = 1e-5
GROUPS = (1, 2, 3, 4)


def make(seed, n=40, m=60, c=1, d=2):
    """numpy float64 (means, conics, values, samples, mask, cotangents)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, d))
    scaling = np.exp(rng.normal(size=(n, d)) * 0.3 - 2.0)
    transforms = rng.normal(size=(n, d * (d - 1) // 2)) * 0.5
    _, conics = build_full_covariances(torch.from_numpy(scaling),
                                       torch.from_numpy(transforms))
    values = rng.normal(size=(n, c))
    samples = rng.uniform(-1.2, 1.2, (m, d))
    mask = rng.uniform(size=n) > 0.25
    shapes = [(m, c), (m, d, c), (m, d, d, c), (m, d, d, d, c)]
    cots = [rng.normal(size=s) for s in shapes]
    return means, conics.numpy(), values, samples, mask, cots


def sym(g):
    return 0.5 * (g + np.swapaxes(g, -1, -2))


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=F64_RTOL,
                               atol=F64_RTOL * np.abs(want).max())


def jax_grads(means, conics, values, samples, mask, cots, order, period):
    def loss(mu, con, v, s):
        out = j_dense(mu, con, v, s, order=order,
                      mask=None if mask is None else jnp.asarray(mask),
                      period=period)
        return sum(jnp.sum(f * c) for f, c in zip(out[:order + 1], cots))
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (means, conics, values, samples)))


def torch_grads(means, conics, values, samples, mask, cots, order, period):
    tin = [torch.from_numpy(x).requires_grad_()
           for x in (means, conics, values, samples)]
    out = eval_mixture(*tin, order=order, period=period,
                       mask=None if mask is None else torch.from_numpy(mask))
    loss = sum(torch.sum(f * torch.from_numpy(c))
               for f, c in zip(out[:order + 1], cots))
    return [g.numpy() for g in torch.autograd.grad(loss, tin)]


CASES = [(order, masked, period) for order in range(4)
         for masked, period in [(False, None), (True, None), (True, 2.0)]]


@pytest.mark.parametrize("order,masked,period", CASES)
@pytest.mark.parametrize("c", [1, 2])
def test_function_grads_match_jax_f64(order, masked, period, c):
    means, conics, values, samples, mask, cots = make(order + 10 * c, c=c)
    mask = mask if masked else None
    want = jax_grads(means, conics, values, samples, mask, cots, order,
                     period)
    got = torch_grads(means, conics, values, samples, mask, cots, order,
                      period)
    close(got[0], want[0])
    close(sym(got[1]), sym(np.asarray(want[1])))
    close(got[2], want[2])
    close(got[3], want[3])


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_d1_grads_match_jax_f64(order):
    means, conics, values, samples, mask, cots = make(30 + order, d=1)
    want = jax_grads(means, conics, values, samples, mask, cots, order, None)
    got = torch_grads(means, conics, values, samples, mask, cots, order, None)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("c,period", [(1, None), (2, None), (2, 2.0)])
def test_plain_twins_match_pallas_backward_interpret_f32(order, c, period):
    means, conics, values, samples, mask, _ = make(50 + order, n=300, m=200,
                                                   c=c)
    values = values * mask[:, None]
    rng = np.random.default_rng(60 + order)
    cots = [rng.normal(size=(200, g * c)).astype(np.float32)
            for g in GROUPS[:order + 1]]
    packed = np.stack([conics[:, 0, 0], conics[:, 0, 1], conics[:, 1, 1]],
                      axis=-1)
    f32 = [x.astype(np.float32) for x in (means, packed, values, samples)]
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_backward(*map(jnp.asarray, f32),
                                tuple(map(jnp.asarray, cots)), order, period,
                                True)
    tin = [torch.from_numpy(x) for x in f32]
    tcots = [torch.from_numpy(x) for x in cots]
    got = list(mk.mixture_backward_gauss_plain(*tin, tcots, order, period,
                                               sample_chunk=64))
    got.append(mk.mixture_backward_sample_plain(*tin, tcots, order, period,
                                                sample_chunk=64))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(g.double().numpy() - w) / np.linalg.norm(w)
        assert err <= F32_NORM_REL, err


def test_gradcheck_f64():
    rng = np.random.default_rng(70)
    n, m = 5, 7
    means = torch.from_numpy(rng.uniform(-1, 1, (n, 2))).requires_grad_()
    packed = torch.from_numpy(np.tile([[3.0, 0.5, 2.0]], (n, 1))
                              + rng.uniform(0, 0.3, (n, 3))).requires_grad_()
    values = torch.from_numpy(rng.normal(size=(n, 2))).requires_grad_()
    samples = torch.from_numpy(rng.uniform(-1, 1, (m, 2))).requires_grad_()
    for order, period in [(0, None), (2, None), (3, 2.0)]:
        assert torch.autograd.gradcheck(
            lambda *a: tuple(mk.mixture_forward(*a, order, period)),
            (means, packed, values, samples))


def test_sample_backward_runs_only_when_samples_need_grad(monkeypatch):
    means, conics, values, samples, _, _ = make(80)
    calls = {"gauss": 0, "sample": 0}
    real_gauss, real_sample = (mk.mixture_backward_gauss,
                               mk.mixture_backward_sample)

    def gauss(*a):
        calls["gauss"] += 1
        return real_gauss(*a)

    def sample(*a):
        calls["sample"] += 1
        return real_sample(*a)

    monkeypatch.setattr(mk, "mixture_backward_gauss", gauss)
    monkeypatch.setattr(mk, "mixture_backward_sample", sample)
    mu, con, v = (torch.from_numpy(x).requires_grad_()
                  for x in (means, conics, values))
    s = torch.from_numpy(samples)
    eval_mixture(mu, con, v, s, order=2).uxx.sum().backward()
    assert calls == {"gauss": 1, "sample": 0}
    s.requires_grad_()
    eval_mixture(mu.detach(), con.detach(), v.detach(), s,
                 order=1).ux.sum().backward()
    assert calls == {"gauss": 1, "sample": 1}
    assert mu.grad is not None and s.grad is not None


def test_second_order_raises():
    """A second-order request no longer raises (the backward was
    ``once_differentiable`` until the double backward was ported): it
    equals torch autograd through the port's own dense oracle in float64.
    tests/test_torch_mixture_double.py holds it against the JAX package."""
    means, conics, values, samples, _, _ = make(81)

    def second(fn):
        mu = torch.from_numpy(means).requires_grad_()
        out = fn(mu, torch.from_numpy(conics), torch.from_numpy(values),
                 torch.from_numpy(samples), order=1)
        # A cotangent that itself requires grad, as inside a second-order
        # loss.
        (g,) = torch.autograd.grad((out.u ** 2).sum(), mu, create_graph=True)
        (gg,) = torch.autograd.grad((g ** 2).sum(), mu)
        return gg.numpy()

    close(second(eval_mixture), second(t_dense))


def test_gauss_slices_cover_the_samples():
    for m, n in [(4096, 1664), (1000, 333), (1, 1), (130, 5000)]:
        _, slices, slice_len = mk.gauss_geometry(m, n, 132)
        assert slices * slice_len >= m and (slices - 1) * slice_len < m
        assert slices == 1 or slice_len % mk.BWD_SLICE_UNIT == 0
    # 13 tiles of 128 Gaussians x 64 slices of 64 samples: 832 blocks.
    assert mk.gauss_geometry(4096, 1664, 132) == (13, 64, 64)
