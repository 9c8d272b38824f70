"""Second-order gradients through the port's mixture against the JAX package
(CPU).

The port's first-order backward is an autograd Function whose own backward
differentiates the dense oracle's vjp again, as the JAX package's
``_bwd_op_bwd`` does.  Each test takes the JAX package's outer/inner loss
(``tests/test_pallas_mixture.py``): an inner loss of squared fields, its
first-order gradients, and an outer loss of their squares.

* Against ``eval_mixture_pallas`` in interpret mode in float32 (n=20, m=30,
  order 2, with and without the samples' gradient): the JAX test's metric,
  max abs / max(1, max |ref|) <= 2e-4.
* Against ``jax.grad`` of ``jax.grad`` through the JAX dense oracle in
  float64, for orders 0-3, c in {1, 2}, mask and period, the samples'
  gradient, and d=1: the same metric at 1e-10.
* Chunked (the pair budget cut to 5 and 7 rows over m=30, 7 not dividing
  30) against unchunked in float64: 1e-12.
* ``torch.autograd.gradgradcheck`` of the Function in float64.
* The double backward launches no kernel of its own: one Gaussian-side
  backward for the inner gradient and one where the outer backward passes
  back through the forward op, the sample side only when the samples need
  a gradient.

The port routes the packed off-diagonal's gradient to C[0, 1] alone; the
JAX Pallas path returns it split evenly.  So the port's outer loss reads the
symmetrized conic gradient, which is the JAX Pallas path's, and conic
gradients are compared symmetrized.  Inputs are made with numpy from fixed
seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pigs_tpu.ops.oracle import eval_mixture_dense as j_dense
from pigs_tpu.ops.pallas_mixture import eval_mixture_pallas
from pigs_tpu_torch.gaussians import build_full_covariances
from pigs_tpu_torch.ops import mixture_kernel as mk
from pigs_tpu_torch.ops.mixture import eval_mixture

F32_SCALED = 2e-4
F64_SCALED = 1e-10
CHUNK_SCALED = 1e-12


def make(seed, n=20, m=30, c=1, d=2):
    """numpy float64 (means, conics, values, samples, mask)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, d))
    scaling = np.exp(rng.normal(size=(n, d)) * 0.3 - 2.0)
    transforms = rng.normal(size=(n, d * (d - 1) // 2)) * 0.5
    _, conics = build_full_covariances(torch.from_numpy(scaling),
                                       torch.from_numpy(transforms))
    values = rng.normal(size=(n, c))
    samples = rng.uniform(-1.2, 1.2, (m, d))
    mask = rng.uniform(size=n) > 0.25
    return means, conics.numpy(), values, samples, mask


def sym(g):
    return 0.5 * (g + np.swapaxes(g, -1, -2))


def assert_scaled(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def inner_terms(out, order):
    return sum((f ** 2).sum() for f in out[:order + 1])


def jax_double(inputs, order, period=None, mask=None, diff_samples=False,
               fn=j_dense):
    """Second-order gradients through JAX: the dense oracle (its conic
    gradient symmetrized before the outer loss) or the Pallas path."""
    dense = fn is j_dense
    samples = jnp.asarray(inputs[3])
    kw = dict(order=order, period=period,
              mask=None if mask is None else jnp.asarray(mask))
    if not dense:
        kw["diff_samples"] = diff_samples

    def outer(*args):
        n_grad = 4 if diff_samples else 3
        smp = args[3] if diff_samples else samples

        def inner(*a):
            out = fn(*a[:3], a[3] if diff_samples else smp, **kw)
            return sum(jnp.sum(f ** 2) for f in out[:order + 1])
        g = list(jax.grad(inner, argnums=tuple(range(n_grad)))(
            *args[:3], smp))
        if dense:
            g[1] = 0.5 * (g[1] + jnp.swapaxes(g[1], -1, -2))
        return sum(jnp.sum(x ** 2) for x in g)

    args = [jnp.asarray(x) for x in inputs]
    argnums = (0, 1, 2, 3) if diff_samples else (0, 1, 2)
    return [np.asarray(x) for x in jax.grad(outer, argnums=argnums)(*args)]


def torch_double(inputs, order, period=None, mask=None, diff_samples=False):
    tin = [torch.from_numpy(x).requires_grad_(k < 3 or diff_samples)
           for k, x in enumerate(inputs)]
    out = eval_mixture(*tin, order=order, period=period,
                       mask=None if mask is None else torch.from_numpy(mask))
    wrt = tin if diff_samples else tin[:3]
    g = list(torch.autograd.grad(inner_terms(out, order), wrt,
                                 create_graph=True))
    g[1] = 0.5 * (g[1] + g[1].transpose(-1, -2))
    outer = sum((x ** 2).sum() for x in g)
    return [x.detach().numpy() for x in torch.autograd.grad(outer, wrt)]


def compare(got, want, tol):
    for k, (a, b) in enumerate(zip(got, want)):
        if k == 1:
            a, b = sym(a), sym(b)
        assert_scaled(a, b, tol)


@pytest.mark.parametrize("diff_samples", [False, True])
def test_second_order_matches_pallas_interpret_f32(diff_samples):
    inputs = [x.astype(np.float32) for x in make(1)[:4]]
    with pltpu.force_tpu_interpret_mode():
        want = jax_double(inputs, 2, diff_samples=diff_samples,
                          fn=eval_mixture_pallas)
    got = torch_double(inputs, 2, diff_samples=diff_samples)
    assert len(got) == (4 if diff_samples else 3)
    compare(got, want, F32_SCALED)


CASES = [(0, 1, False, None, True), (1, 2, True, None, False),
         (1, 1, False, 2.0, True), (2, 1, True, 2.0, False),
         (2, 2, False, None, True), (3, 2, False, 2.0, False),
         (3, 1, True, None, True)]


@pytest.mark.parametrize("order,c,masked,period,diff_samples", CASES)
def test_second_order_matches_jax_dense_f64(order, c, masked, period,
                                            diff_samples):
    *inputs, mask = make(10 + order, c=c)
    mask = mask if masked else None
    want = jax_double(inputs, order, period, mask, diff_samples)
    got = torch_double(inputs, order, period, mask, diff_samples)
    compare(got, want, F64_SCALED)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_second_order_d1_matches_jax_dense_f64(order):
    *inputs, mask = make(20 + order, d=1, c=2)
    for diff_samples in (False, True):
        want = jax_double(inputs, order, None, mask, diff_samples)
        got = torch_double(inputs, order, None, mask, diff_samples)
        compare(got, want, F64_SCALED)


@pytest.mark.parametrize("rows", [5, 7])
def test_second_order_chunked_equals_unchunked(monkeypatch, rows):
    *inputs, mask = make(30, c=2)
    want = torch_double(inputs, 2, 2.0, mask, diff_samples=True)
    monkeypatch.setattr(mk, "SECOND_ORDER_PAIR_BUDGET",
                        rows * inputs[0].shape[0])
    calls = []
    real = mk._double_vjp
    monkeypatch.setattr(mk, "_double_vjp",
                        lambda p, *a: calls.append(p[3].shape[0])
                        or real(p, *a))
    got = torch_double(inputs, 2, 2.0, mask, diff_samples=True)
    assert calls == [rows] * (30 // rows) + [30 % rows] * (30 % rows > 0)
    for a, b in zip(got, want):
        assert_scaled(a, b, CHUNK_SCALED)


def test_gradgradcheck_f64():
    rng = np.random.default_rng(70)
    n, m = 5, 7
    means = torch.from_numpy(rng.uniform(-1, 1, (n, 2))).requires_grad_()
    packed = torch.from_numpy(np.tile([[3.0, 0.5, 2.0]], (n, 1))
                              + rng.uniform(0, 0.3, (n, 3))).requires_grad_()
    values = torch.from_numpy(rng.normal(size=(n, 2))).requires_grad_()
    samples = torch.from_numpy(rng.uniform(-1, 1, (m, 2))).requires_grad_()
    assert torch.autograd.gradgradcheck(
        lambda *a: tuple(mk.mixture_forward(*a, 2, None)),
        (means, packed, values, samples))
    assert torch.autograd.gradgradcheck(
        lambda *a: tuple(mk.mixture_forward(*a, samples.detach(), 3, 2.0)),
        (means, packed, values))


def test_double_backward_runs_the_first_order_backward_twice(monkeypatch):
    """Inner gradient: one Gaussian-side backward (and one sample-side when
    the samples need a gradient).  Outer backward: the dense double vjp,
    then one more first-order backward where the inner loss's cotangents
    lead back through the forward op."""
    *inputs, _ = make(40)
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
    torch_double(inputs, 2)
    assert calls == {"gauss": 2, "sample": 0}
    torch_double(inputs, 2, diff_samples=True)
    assert calls == {"gauss": 4, "sample": 2}


def test_first_order_backward_calls_the_kernels_directly(monkeypatch):
    """Without create_graph the backward never builds the differentiable
    op, so a training step pays nothing for second-order support."""
    def refuse(*a):
        raise AssertionError("_MixtureBackward built on a first-order pass")

    monkeypatch.setattr(mk._MixtureBackward, "apply", refuse)
    *inputs, _ = make(41)
    tin = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = eval_mixture(*tin, order=2)
    grads = torch.autograd.grad(inner_terms(out, 2), tin)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(AssertionError, match="first-order pass"):
        torch.autograd.grad(inner_terms(eval_mixture(*tin, order=2), 2), tin,
                            create_graph=True)
