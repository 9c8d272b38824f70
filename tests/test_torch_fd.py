"""Parity of the port's finite-difference and spectral solvers
(``pigs_tpu_torch.utils.fd``) with ``pigs_tpu.utils.fd``.

* ``solve_fd_1d`` and ``solve_fd_2d`` for diffusion, Burgers and wave,
  Dirichlet and periodic, and ``solve_ns_2d`` with and without ``res_out``,
  on small grids in float64: norm-relative <= 1e-9 (the same operations in
  the same order; only the backends' rounding differs).
* ``solve_ns_2d``'s errors for an odd or out-of-range ``res_out``.
* ``random_vorticity``'s spectral shaping fed JAX's normal draw: <= 1e-9.
* ``solve_fd_2d`` from frame 0 of the flagship fixture's FD frames
  (artifacts/burgers_ns4096_ema2_torch.npz, written by JAX in float32)
  reproduces all 50 stored frames in float32 within 1e-6 norm-relative per
  frame: a few units of float32's 6e-8 resolution, from 400 RK4 substeps a
  frame that the two backends round differently (the same operations in
  the same order).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.utils import fd as jfd
from pigs_tpu_torch.utils import fd as tfd

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "artifacts" / "burgers_ns4096_ema2_torch.npz"
TOL = 1e-9
FIXTURE_TOL = 1e-6
FIXTURE_STEPS = 50


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bump(res, scale, c=1, seed=0):
    """A Gaussian bump with a little noise, (res,) or (res, 2) in 1D."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, res) * scale
    u = np.exp(-2.0 * x ** 2) + 0.01 * rng.standard_normal(res)
    if c == 2:
        u = np.stack([u, 0.1 * rng.standard_normal(res)], axis=-1)
    return u


def bump2(res, scale, c=1, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, res) * scale
    gx, gy = np.meshgrid(x, x, indexing="ij")
    u = np.exp(-(gx ** 2 + gy ** 2) / 0.25) + 0.01 * rng.standard_normal(
        (res, res))
    if c == 2:
        u = np.stack([u, 0.1 * rng.standard_normal((res, res))], axis=-1)
    return u


CASES = [(p, per) for p in ("diffusion", "burgers", "wave")
         for per in (False, True)]


@pytest.mark.parametrize("problem,periodic", CASES)
def test_solve_fd_1d_matches_jax(problem, periodic):
    u0 = bump(33, 2.5, 2 if problem == "wave" else 1)
    args = dict(scale=2.5, dt=0.05, steps=3, problem=problem, nu=0.0318,
                substeps=40, periodic=periodic)
    want = np.asarray(jfd.solve_fd_1d(jnp.asarray(u0), **args))
    got = tfd.solve_fd_1d(torch.from_numpy(u0), **args).numpy()
    assert got.shape == want.shape == (4,) + u0.shape
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("problem,periodic", CASES)
def test_solve_fd_2d_matches_jax(problem, periodic):
    u0 = bump2(17, 2.5, 2 if problem == "wave" else 1)
    args = dict(scale=2.5, dt=0.02, steps=3, problem=problem, nu=0.0318,
                substeps=20, periodic=periodic)
    want = np.asarray(jfd.solve_fd_2d(jnp.asarray(u0), **args))
    got = tfd.solve_fd_2d(torch.from_numpy(u0), **args).numpy()
    assert got.shape == want.shape == (4,) + u0.shape
    assert rel(got, want) <= TOL
    if not periodic:
        assert np.all(got[1:, 0] == 0) and np.all(got[1:, :, -1] == 0)


def test_fd_defaults_match_jax():
    """The different nu defaults (1D 0.00318, 2D 0.0318) carry over."""
    u0 = bump(21, 2.5)
    want = np.asarray(jfd.solve_fd_1d(jnp.asarray(u0), 2.5, 0.05, 1,
                                      substeps=10))
    got = tfd.solve_fd_1d(torch.from_numpy(u0), 2.5, 0.05, 1,
                          substeps=10).numpy()
    assert rel(got, want) <= TOL
    u2 = bump2(16, 2.5)
    want = np.asarray(jfd.solve_fd_2d(jnp.asarray(u2), 2.5, 0.05, 1,
                                      substeps=10))
    got = tfd.solve_fd_2d(torch.from_numpy(u2), 2.5, 0.05, 1,
                          substeps=10).numpy()
    assert rel(got, want) <= TOL


@pytest.fixture(scope="module")
def vorticity():
    """A random vorticity field drawn and shaped by JAX (float64)."""
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (32, 32), jnp.float64))
    return noise, np.asarray(jfd.random_vorticity(key, 32, scale=1.0))


def test_random_vorticity_shaping_matches_jax(vorticity):
    noise, want = vorticity
    got = tfd.vorticity_from_noise(torch.tensor(noise), scale=1.0)
    assert rel(got.numpy(), want) <= TOL
    assert float(torch.max(torch.abs(got))) == pytest.approx(1.0)
    gen = torch.Generator().manual_seed(0)
    w = tfd.random_vorticity(gen, 16, scale=1.0, amplitude=2.0,
                             dtype=torch.float64)
    assert w.shape == (16, 16) and w.dtype == torch.float64
    assert float(torch.max(torch.abs(w))) == pytest.approx(2.0)
    assert abs(float(w.mean())) < 1e-12          # no k = 0 component


@pytest.mark.parametrize("res_out", [None, 16])
def test_solve_ns_2d_matches_jax(vorticity, res_out):
    _, w0 = vorticity
    args = dict(scale=1.0, dt=0.05, steps=2, nu=1e-3, substeps=4,
                res_out=res_out)
    want = np.asarray(jfd.solve_ns_2d(jnp.asarray(w0), **args))
    got = tfd.solve_ns_2d(torch.from_numpy(w0), **args).numpy()
    side = res_out or 32
    assert got.shape == want.shape == (3, side, side)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("res_out,match", [(15, "even"), (32, None),
                                           (40, "must be in"),
                                           (0, "must be in")])
def test_solve_ns_2d_res_out_checks(vorticity, res_out, match):
    w0 = torch.from_numpy(vorticity[1])
    if match is None:     # res_out == res: no truncation
        out = tfd.solve_ns_2d(w0, 1.0, 0.05, 1, substeps=2, res_out=res_out)
        assert out.shape == (2, 32, 32)
        return
    with pytest.raises(ValueError, match=match):
        tfd.solve_ns_2d(w0, 1.0, 0.05, 1, substeps=2, res_out=res_out)


@pytest.fixture(scope="module")
def flagship_fd():
    """The fixture's FD frames (image layout) and the first FIXTURE_STEPS
    outer steps of the port's solver from frame 0, flipped back to the
    solver's layout (axis 0 = x) as the exporter flipped it."""
    with np.load(FIXTURE) as z:
        frames = z["fd_frames"][:FIXTURE_STEPS + 1]
        dt = float(z["config_dt"])
    u0 = torch.from_numpy(np.ascontiguousarray(np.flipud(frames[0]).T))
    out = tfd.solve_fd_2d(u0, 1.0, dt, FIXTURE_STEPS, problem="burgers",
                          nu=1.0 / (10.0 * np.pi))
    got = np.stack([np.flipud(g.T) for g in out.numpy()])
    return got, frames


def test_solve_fd_2d_reproduces_fixture_frames(flagship_fd):
    got, want = flagship_fd
    assert got.dtype == np.float32
    errs = [rel(a, b) for a, b in zip(got, want)]
    assert errs[0] == 0.0
    assert max(errs) <= FIXTURE_TOL, errs
