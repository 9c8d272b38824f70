"""Parity of the port's covariance algebra, padded state, samplers and PDE
right-hand sides with the JAX package (float64, CPU).

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerance: rtol 1e-12 -- the two sides evaluate the same closed forms in the
same order in float64; only libm's tanh/sqrt/exp may differ in the last ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu import gaussians as jg
from pigs_tpu import pde as jpde
from pigs_tpu.models import state as jstate
from pigs_tpu.utils import sampling as jsampling
from pigs_tpu_torch import gaussians as tg
from pigs_tpu_torch import pde as tpde
from pigs_tpu_torch.models import state as tstate
from pigs_tpu_torch.utils import sampling as tsampling

RTOL = 1e-12


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_build_full_covariances(d):
    rng = np.random.default_rng(d)
    scaling = np.exp(rng.normal(size=(9, d)) * 0.3 - 2.0)
    transforms = rng.normal(size=(9, d * (d - 1) // 2))
    jc, jk = jg.build_full_covariances(jnp.asarray(scaling),
                                       jnp.asarray(transforms))
    tc, tk = tg.build_full_covariances(t(scaling), t(transforms))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=RTOL)
    # The conic is the inverse.
    eye = np.broadcast_to(np.eye(d), (9, d, d))
    np.testing.assert_allclose((tc @ tk).numpy(), eye, atol=1e-10)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_packed_covariances(d):
    assert (tg.tri_size(d), tg.off_diag_size(d)) == (jg.tri_size(d),
                                                     jg.off_diag_size(d))
    rng = np.random.default_rng(10 + d)
    scaling = np.exp(rng.normal(size=(7, d)) * 0.3 - 2.0)
    transforms = rng.normal(size=(7, d * (d - 1) // 2))
    want = jg.build_covariances(jnp.asarray(scaling), jnp.asarray(transforms))
    got = tg.build_covariances(t(scaling), t(transforms))
    for g, w in zip(got, want):
        assert g.shape == (7, tg.tri_size(d))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    cov, con = tg.build_full_covariances(t(scaling), t(transforms))
    for g, w in zip(tg.flatten_covariances(cov, con),
                    jg.flatten_covariances(jnp.asarray(cov.numpy()),
                                           jnp.asarray(con.numpy()))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_init_state_and_covariance_of():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(7, 2)), np.exp(rng.normal(size=(7, 2))),
              rng.normal(size=(7, 1)), rng.normal(size=(7, 1))]
    bnd = [rng.normal(size=(3, 2)), np.exp(rng.normal(size=(3, 2))),
           rng.normal(size=(3, 1)), rng.normal(size=(3, 1))]
    js = jstate.init_state(16, *map(jnp.asarray, arrays + bnd))
    ts = tstate.init_state(16, *map(t, arrays + bnd))
    for name in js._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    # Free slots keep scaling 1, so their conics are finite.
    assert (ts.scaling[10:] == 1.0).all()
    assert ts.interior.numpy().tolist() == np.asarray(js.interior).tolist()
    for a, b in zip(tstate.covariance_of(ts), jstate.covariance_of(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    with pytest.raises(ValueError, match="capacity 8 < initial Gaussian count 10"):
        tstate.init_state(8, *map(t, arrays + bnd))


@pytest.mark.parametrize("res", [1, 5, 16])
def test_samplers(res):
    # torch.linspace and jnp.linspace may place a point one ulp apart.
    np.testing.assert_allclose(
        tsampling.image_samples(res, 1.5, torch.float64).numpy(),
        np.asarray(jsampling.image_samples(res, 1.5, jnp.float64)),
        rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        tsampling.grid_samples(res, 2, 1.5, torch.float64).numpy(),
        np.asarray(jsampling.grid_samples(res, 2, 1.5, jnp.float64)),
        rtol=0, atol=1e-15)
    # Image layout: row 0 is y = +scale, x runs along the row.
    img = tsampling.image_samples(res, 1.5, torch.float64).reshape(res, res, 2)
    if res > 1:
        assert img[0, 0, 1] == 1.5
    assert (img[:, :, 0] == img[0, :, 0]).all()


@pytest.mark.parametrize("size,dx,d", [(1, 0.1, 2), (4, 0.05, 2),
                                       (5, 0.2, 1), (3, 0.1, 3)])
def test_region_kernel(size, dx, d):
    want = jsampling.region_kernel(size, dx, d, dtype=jnp.float64)
    got = tsampling.region_kernel(size, dx, d, dtype=torch.float64)
    assert got.shape == (size ** d, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-15)


@pytest.mark.parametrize("problem", list(tpde.Problem),
                         ids=lambda p: p.name)
def test_pde_rhs(problem):
    jp = jpde.Problem[problem.name]
    assert tpde.channels(problem) == jpde.channels(jp)
    assert tpde.pde_size(problem) == jpde.pde_size(jp)
    assert tpde.PDECoefficients.default(problem) == tuple(
        jpde.PDECoefficients.default(jp))
    c = tpde.channels(problem)
    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=s) for s in
              [(11, 2), (11, c), (11, 2, c), (11, 2, 2, c), (11, 2),
               (11, 2, 2)]]
    coeff = tpde.PDECoefficients.default(problem)._replace(wave_psi_scale=3.0)
    jcoeff = jpde.PDECoefficients.default(jp)._replace(wave_psi_scale=3.0)
    got = tpde.pde_rhs(problem, coeff, *map(t, arrays), t=0.7)
    want = jpde.pde_rhs(jp, jcoeff, *map(jnp.asarray, arrays), t=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-15)
