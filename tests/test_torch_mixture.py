"""Parity of the port's mixture evaluation with the JAX package (CPU).

* The dense oracle and ``eval_mixture`` (its d in {1, 2} route runs the
  plain twin of the CUDA kernel K1 on CPU tensors; d=3 and ``impl="plain"``
  run the blockwise path) against JAX's ``eval_mixture_dense`` in float64,
  rtol 1e-10: the same sums in another order, so differences are a few ulp
  of the largest term.
* The plain K1 twin against the Pallas kernel run in interpret mode in
  float32, norm-relative 1e-5: both sum in float32 in different orders
  (the Pallas tile sums through a matmul and Kahan-adds across tiles).
* d=1 against JAX's embedding of d=1 in the d=2 kernel, float32, 1e-5.

Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pigs_tpu.ops import mixture as jmixture
from pigs_tpu.ops.oracle import eval_mixture_dense as j_dense
from pigs_tpu.ops.pallas_mixture import eval_mixture_pallas
from pigs_tpu_torch.gaussians import build_full_covariances
from pigs_tpu_torch.ops import mixture_kernel
from pigs_tpu_torch.ops.mixture import (eval_mixture, eval_mixture_image,
                                        eval_mixture_region)
from pigs_tpu_torch.ops.oracle import eval_mixture_dense

F64_RTOL = 1e-10
F32_NORM_REL = 1e-5


def make(seed, n=70, m=130, c=1, d=2):
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


def fields_close(got, want, rtol=F64_RTOL):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                       atol=rtol * np.abs(w).max())


def norm_rel(got, want):
    worst = 0.0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            w = np.asarray(w, np.float64)
            worst = max(worst, np.linalg.norm(g.numpy() - w)
                        / np.linalg.norm(w))
    return worst


CASES = [(order, masked, period) for order in range(4)
         for masked, period in [(False, None), (True, None), (True, 2.0)]]


@pytest.mark.parametrize("order,masked,period", CASES)
@pytest.mark.parametrize("c", [1, 2])
def test_oracle_and_eval_mixture_match_jax_f64(order, masked, period, c):
    means, conics, values, samples, mask = make(order, c=c)
    mask = mask if masked else None
    want = j_dense(*map(jnp.asarray, (means, conics, values, samples)),
                   order=order, mask=None if mask is None else jnp.asarray(mask),
                   period=period)
    tin = [torch.from_numpy(x) for x in (means, conics, values, samples)]
    tmask = None if mask is None else torch.from_numpy(mask)
    fields_close(eval_mixture_dense(*tin, order=order, mask=tmask,
                                    period=period), want)
    # Default route (the K1 twin on CPU) and the blockwise path, chunked.
    fields_close(eval_mixture(*tin, order=order, mask=tmask, period=period,
                              ), want)
    fields_close(eval_mixture(*tin, order=order, mask=tmask, period=period,
                              sample_chunk=32, impl="plain"), want)


@pytest.mark.parametrize("order", [0, 2, 3])
def test_eval_mixture_d3_blockwise(order):
    means, conics, values, samples, mask = make(5, d=3)
    want = j_dense(*map(jnp.asarray, (means, conics, values, samples)),
                   order=order, mask=jnp.asarray(mask))
    got = eval_mixture(*[torch.from_numpy(x) for x in
                         (means, conics, values, samples)], order=order,
                       mask=torch.from_numpy(mask), sample_chunk=50)
    fields_close(got, want)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("c,period", [(1, None), (2, None), (2, 2.0)])
def test_plain_twin_matches_pallas_interpret_f32(order, c, period):
    means, conics, values, samples, mask = make(10 + order, n=300, m=200, c=c)
    f32 = [x.astype(np.float32) for x in (means, conics, values, samples)]
    with pltpu.force_tpu_interpret_mode():
        want = eval_mixture_pallas(*map(jnp.asarray, f32), order=order,
                                   mask=jnp.asarray(mask), period=period)
    tin = [torch.from_numpy(x) for x in f32]
    v = tin[2] * torch.from_numpy(mask).float()[:, None]
    outs = mixture_kernel.mixture_forward_plain(
        tin[0], mixture_kernel.pack_conics(tin[1]), v, tin[3], order, period,
        sample_chunk=64)
    got = mixture_kernel.unpack_fields(outs, 200, c, order)
    assert all(x is None or x.dtype == torch.float32 for x in got)
    assert norm_rel(got, want) <= F32_NORM_REL


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_d1_matches_jax_embedding_f32(order):
    means, conics, values, samples, mask = make(20 + order, d=1)
    f32 = [x.astype(np.float32) for x in (means, conics, values, samples)]
    with pltpu.force_tpu_interpret_mode():
        want = jmixture._eval_d1_via_d2(*map(jnp.asarray, f32), order=order,
                                        mask=jnp.asarray(mask), period=None,
                                        diff_samples=False)
    got = eval_mixture(*[torch.from_numpy(x) for x in f32], order=order,
                       mask=torch.from_numpy(mask))
    assert got.u.shape == (130, 1)
    assert norm_rel(got, want) <= F32_NORM_REL
    # ... and the embedding is exact against the 1D oracle in float64.
    want64 = j_dense(*map(jnp.asarray, (means, conics, values, samples)),
                     order=order, mask=jnp.asarray(mask))
    fields_close(eval_mixture(*[torch.from_numpy(x) for x in
                                (means, conics, values, samples)],
                              order=order, mask=torch.from_numpy(mask)),
                 want64)


def test_eval_mixture_image_matches_jax():
    means, conics, values, _, mask = make(30, c=2)
    want = jmixture.eval_mixture_image(
        *map(jnp.asarray, (means, conics, values)), res=9, scale=1.3,
        mask=jnp.asarray(mask))
    got = eval_mixture_image(*[torch.from_numpy(x) for x in
                               (means, conics, values)], res=9, scale=1.3,
                             mask=torch.from_numpy(mask))
    assert got.shape == (9, 9, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F64_RTOL,
                               atol=1e-14)


@pytest.mark.parametrize("d,order", [(2, 2), (1, 1)])
def test_eval_mixture_region_matches_jax(d, order):
    means, conics, values, _, mask = make(31, c=2, d=d)
    center = np.full(d, 0.15)
    want = jmixture.eval_mixture_region(
        *map(jnp.asarray, (means, conics, values)), center, size=5, dx=0.07,
        order=order, mask=jnp.asarray(mask))
    got = eval_mixture_region(*[torch.from_numpy(x) for x in
                                (means, conics, values)], center, size=5,
                              dx=0.07, order=order,
                              mask=torch.from_numpy(mask))
    assert got.u.shape == (5 ** d, 2)
    fields_close(got, want)


def test_cpu_route_never_counts_a_launch():
    means, conics, values, samples, _ = make(40)
    before = mixture_kernel.launches
    eval_mixture(*[torch.from_numpy(x).float() for x in
                   (means, conics, values, samples)], order=2)
    assert mixture_kernel.launches == before


def test_dispatch_rejects_what_no_path_takes():
    means, conics, values, samples, _ = make(41)
    tin = [torch.from_numpy(x).float() for x in (means, conics, values, samples)]
    with pytest.raises(ValueError, match="impl must be"):
        eval_mixture(*tin, impl="pallas")
    # A device with neither a kernel nor a plain route raises.
    meta = [x.to("meta") for x in tin]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mixture_kernel.mixture_forward(
            meta[0], mixture_kernel.pack_conics(meta[1]), meta[2], meta[3], 0)
    with pytest.raises(ValueError, match="several devices"):
        mixture_kernel.mixture_forward(
            meta[0], mixture_kernel.pack_conics(tin[1]), tin[2], tin[3], 0)
