"""The port's NS data pipeline (``pigs_tpu_torch.train.ns_data``) and its
native .npy reader (``pigs_tpu_torch.native``) on the CPU.

* the native library builds under ``build/pigs_tpu_torch/native/`` and
  passes ``tests/test_native.py``'s cases;
* ``load_fno``'s layout, and its rejection of a file that is not 4-D;
* ``generate_fno`` on JAX's noise (the draws ``pigs_tpu.train.ns_data.
  generate_fno`` makes, injected) against JAX's file at a small grid, in
  float64: <= 1e-9;
* the fit fixture's float32 draws (``generate_fno(seed=1)``'s, exported by
  ``scripts/export_torch_fixture.py --kind fit``) regenerating trajectory
  7's frames 0-3 of artifacts/ns_data_8traj.npz within twice the port's
  float32 error over every trajectory's frames 0-3 (8.0e-5);
* ``convert_fno`` -> ``NSDataset.load``: JAX's keys, dtypes and shapes, the
  [y, x] layout, and a curl fit that reduces its objective;
* ``fit_fno_trajectory``'s return structure and its seeding.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.train import ns_data as jns
from pigs_tpu_torch import native
from pigs_tpu_torch.native import NpyFile, RandomRowLoader, get_lib
from pigs_tpu_torch.train import ns_data as tns
from pigs_tpu_torch.train.pn import NSDataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIT_FIXTURE = ROOT / "artifacts" / "fit_torch.npz"
NS_DATA = ROOT / "artifacts" / "ns_data_8traj.npz"
# Twice the port's float32 CPU error against the committed frames 0-3 of
# all 8 trajectories (8.0e-5 max abs).
EARLY_FRAMES_TOL = 1.6e-4
quiet = lambda *_: None


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The spectral solver's many small FFTs slow down by an order of
    magnitude when torch's threads outnumber the free cores (parallel test
    workers); two threads keep them quick."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_fixture", ROOT / "scripts" / "export_torch_fixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def npy_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "arr.npy"
    arr = np.arange(37 * 5 * 3, dtype=np.float32).reshape(37, 5, 3)
    np.save(path, arr)
    return str(path), arr


# ------------------------------------------------------- the native reader


def test_native_lib_builds_under_build():
    assert get_lib() is not None, "g++ build of libpigs_host.so failed"
    so = pathlib.Path(native._SO)
    assert so.exists()
    assert so.parent == ROOT / "build" / "pigs_tpu_torch" / "native"
    assert not (ROOT / "pigs_tpu_torch" / "native" / "libpigs_host.so").exists()


def test_npy_file_matches_numpy(npy_path):
    path, arr = npy_path
    f = NpyFile(path)
    assert f.native
    assert f.shape == arr.shape and f.dtype == arr.dtype
    np.testing.assert_array_equal(np.asarray(f.array), arr)
    f.close()


def test_npy_file_f64_and_1d(tmp_path):
    path = str(tmp_path / "b.npy")
    arr = np.linspace(0, 1, 11)
    np.save(path, arr)
    f = NpyFile(path)
    np.testing.assert_array_equal(np.asarray(f.array), arr)
    f.close()


def test_npy_open_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        NpyFile(str(tmp_path / "missing.npy"))


def test_npy_fortran_order_falls_back_to_numpy(tmp_path):
    path = str(tmp_path / "f.npy")
    arr = np.arange(12.0).reshape(3, 4)
    np.save(path, np.asfortranarray(arr))
    f = NpyFile(path)
    assert not f.native
    np.testing.assert_array_equal(np.asarray(f.array), arr)
    f.close()


def test_loader_batches_are_owned_copies(npy_path):
    path, arr = npy_path
    f = NpyFile(path)
    loader = RandomRowLoader(f, rows_per_batch=4, depth=2, num_threads=2,
                             seed=3)
    batches = [loader.next() for _ in range(10)]  # 5x the ring depth
    for batch, idx in batches:
        np.testing.assert_array_equal(batch, arr[idx])
    loader.close()
    f.close()


def test_random_row_loader(npy_path):
    path, arr = npy_path
    f = NpyFile(path)
    loader = RandomRowLoader(f, rows_per_batch=4, depth=3, num_threads=2,
                             seed=7)
    assert loader.native
    seen = set()
    for _ in range(20):
        batch, idx = loader.next()
        assert batch.shape == (4, 5, 3)
        np.testing.assert_array_equal(batch, arr[idx])
        seen.update(idx.tolist())
    assert len(seen) > 10
    loader.close()
    f.close()


# ----------------------------------------------------------- load_fno ----


def test_load_fno_layout(tmp_path):
    path = str(tmp_path / "fno.npy")
    raw = np.random.default_rng(0).standard_normal((5, 6, 6, 3)).astype(
        np.float32)                                # (T, res, res, N)
    np.save(path, raw)
    got = tns.load_fno(path)
    assert got.shape == (3, 6, 6, 5)
    np.testing.assert_array_equal(got, np.transpose(raw, (3, 1, 2, 0)))
    np.testing.assert_array_equal(got, jns.load_fno(path))


def test_load_fno_rejects_non_4d(tmp_path):
    path = str(tmp_path / "bad.npy")
    np.save(path, np.zeros((4, 6, 6), np.float32))
    with pytest.raises(ValueError, match="4D"):
        tns.load_fno(path)


# -------------------------------------------------------- generate_fno ----


def test_generate_fno_matches_jax_on_its_noise(tmp_path, exporter):
    """In float64 (the tests run JAX with x64, so JAX draws float64
    noise): the same white noise gives the same file."""
    kw = dict(n_traj=2, res=16, steps=3, dt=0.2, nu=1e-3, seed=3,
              gen_res=32, log_fn=quiet)
    jpath, tpath = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    jns.generate_fno(jpath, **kw)
    noise = exporter.jax_fno_noise(3, 2, 32, dtype=jnp.float64)
    tns.generate_fno(tpath, noise=torch.tensor(noise), **kw)
    want, got = np.load(jpath), np.load(tpath)
    assert got.shape == want.shape == (4, 16, 16, 2)
    assert got.dtype == want.dtype == np.float32
    assert np.linalg.norm(got - want) <= 1e-9 * np.linalg.norm(want)


def test_generate_fno_draws_its_own_noise(tmp_path):
    path = str(tmp_path / "own.npy")
    kw = dict(n_traj=2, res=8, steps=1, dt=0.1, gen_res=16, log_fn=quiet)
    tns.generate_fno(path, seed=5, **kw)
    a = np.load(path)
    tns.generate_fno(path, seed=5, **kw)
    assert np.array_equal(a, np.load(path))
    tns.generate_fno(path, seed=6, **kw)
    assert not np.allclose(a, np.load(path))
    assert a.shape == (2, 8, 8, 2) and np.isfinite(a).all()
    with pytest.raises(ValueError, match="noise of shape"):
        tns.generate_fno(path, noise=torch.zeros((3, 16, 16)), **kw)


def test_fixture_noise_regenerates_trajectory_7():
    """generate_fno(seed=1)'s JAX draws (float32) regenerate the committed
    dataset: trajectory 7's frames 0-3."""
    with np.load(FIT_FIXTURE) as z:
        noise = torch.tensor(z["noise"][7:8])
    with np.load(NS_DATA) as z:
        committed = z["frames"][7, :, :, :4]       # (64, 64, 4)
    got = tns.generate_trajectories(noise, res=64, steps=3)[..., 0].numpy()
    err = np.abs(np.moveaxis(got, 0, -1) - committed).max()
    print(f"trajectory 7 frames 0-3: max abs {err:.3e}")
    assert err <= EARLY_FRAMES_TOL


# ---------------------------------------------------- convert_fno / fits --


@pytest.fixture(scope="module")
def small_fno(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fno") / "ns.npy")
    tns.generate_fno(path, n_traj=2, res=24, steps=3, dt=0.2, seed=3,
                     gen_res=48, log_fn=quiet)
    return path


def test_convert_fno_round_trip(small_fno, tmp_path):
    """generate_fno -> convert_fno -> NSDataset.load: JAX's keys, dtypes and
    shapes, the [y, x] layout lines up with recon_target, and the curl fit
    reduces its objective on the frame."""
    raw = np.load(small_fno)
    assert raw.shape == (4, 24, 24, 2)
    npz, jnpz = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tns.convert_fno(small_fno, npz, nx=6, iters=60, log_fn=quiet)
    jns.convert_fno(small_fno, jnpz, nx=6, iters=60, log_fn=quiet)
    with np.load(npz) as t, np.load(jnpz) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        assert np.array_equal(t["frames"], j["frames"])
    ds = NSDataset.load(npz)
    assert ds.means.shape[0] == 2 and ds.frames.shape == (2, 24, 24, 4)
    frame = ds.frames[0, :, :, 0].numpy()
    iy, ix = np.unravel_index(np.argmax(frame), frame.shape)
    sample = torch.tensor([[(ix + 0.5) / 24 * 2 - 1, (iy + 0.5) / 24 * 2 - 1]])
    assert abs(float(ds.recon_target(0, 0, sample)[0]) - frame[iy, ix]) < 1e-6
    *_, loss = tns.fit_fno_trajectory(frame, nx=6, iters=200)
    assert np.isfinite(loss) and loss < 0.5 * float((frame ** 2).mean())


def test_convert_fno_count_and_seeds(small_fno, tmp_path):
    """``count`` trajectories; trajectory i is fitted from seed + i."""
    npz = str(tmp_path / "one.npz")
    tns.convert_fno(small_fno, npz, count=1, nx=4, iters=20, seed=5,
                    log_fn=quiet)
    frame = tns.load_fno(small_fno)[0, :, :, 0]
    means, *_ = tns.fit_fno_trajectory(frame, nx=4, iters=20, seed=5)
    with np.load(npz) as z:
        assert z["means"].shape[0] == 1
        assert np.array_equal(z["means"][0], means)


def test_fit_fno_trajectory_structure(small_fno):
    frame = tns.load_fno(small_fno)[1, :, :, 0]
    out = tns.fit_fno_trajectory(frame, nx=5, iters=30, block_iters=10,
                                 seed=2)
    assert len(out) == 5
    means, u, scaling, transforms, loss = out
    assert means.shape == (25, 2) and u.shape == (25, 2)
    assert scaling.shape == (25, 2) and transforms.shape == (25, 1)
    assert all(x.dtype == np.float32 for x in out[:4])
    assert isinstance(loss, float) and np.isfinite(loss)
    assert (scaling > 0).all()
    assert (means >= -1).all() and (means < 1).all()   # wrapped, periodic
    again = tns.fit_fno_trajectory(frame, nx=5, iters=30, block_iters=10,
                                   seed=2)
    assert all(np.array_equal(a, b) for a, b in zip(out[:4], again[:4]))
    cfg = tns.fit_config(5, 30, 10)
    assert (cfg.capacity, cfg.curl, cfg.periodic, cfg.tanh_means,
            cfg.block_iters) == (25, True, True, False, 10)
