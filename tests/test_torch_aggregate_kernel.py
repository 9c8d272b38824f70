"""Parity of the port's fused aggregation (pigs_tpu_torch.ops.aggregate_kernel)
with the JAX package's Pallas kernel (pigs_tpu.ops.pallas_aggregate).

The CPU has no CUDA kernel: ``aggregate_neighbors_fused`` on CPU tensors runs
the plain twins through the same autograd Function that launches K4/K5 on
the card.  The JAX side runs the Pallas kernel in interpret mode, as
tests/test_pallas_aggregate.py does.  Inputs are made with numpy from fixed
seeds, in float32.  Tolerances are that file's: rtol 2e-4 / atol 2e-5 for
outputs, atol 5e-5 (1e-4 for the means) on gradients divided by their scale
-- float32 on both sides, summed in different orders.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pigs_tpu.ops import pallas_aggregate as jpa
from pigs_tpu_torch.ops import aggregate as tagg
from pigs_tpu_torch.ops import aggregate_kernel as ak

RTOL, ATOL = 2e-4, 2e-5
NAMES = ("features", "transform", "queries", "keys", "frequencies",
         "distance_transform")


def make(n=60, L=8, K=4, F=6, seed=0, log_var=-3.0, active_frac=1.0,
         spread=1.0):
    """numpy inputs: the six aggregation inputs, means, diagonal
    covariances and the active mask (None when every slot is active)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    E = 1 + 2 * F * 2
    args = dict(
        features=rng.normal(size=(n, L)).astype(f32),
        transform=rng.normal(size=(L, L)).astype(f32),
        queries=rng.normal(size=(n, K)).astype(f32),
        keys=rng.normal(size=(n, K)).astype(f32),
        frequencies=(rng.normal(size=(F,)) * 10).astype(f32),
        distance_transform=rng.normal(size=(L, 2 * E)).astype(f32))
    means = (rng.uniform(-1.0, 1.0, (n, 2)) * spread).astype(f32)
    var = np.exp(rng.normal(size=(n, 2)) * 0.2 + log_var).astype(f32)
    cov = np.zeros((n, 2, 2), f32)
    cov[:, 0, 0], cov[:, 1, 1] = var[:, 0], var[:, 1]
    active = None
    if active_frac < 1.0:
        active = rng.uniform(size=n) < active_frac
    return args, means, cov, active


def torch_radii(cov, active):
    return ak.radii_of(torch.from_numpy(cov),
                       None if active is None else torch.from_numpy(active))


def jax_fused(args, means, cov, active, period=None):
    radii = jpa.radii_of(jnp.asarray(cov),
                         None if active is None else jnp.asarray(active))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jpa.aggregate_neighbors_pallas(
            *(jnp.asarray(args[k]) for k in NAMES), jnp.asarray(means),
            radii, period=period))


CASES = {
    "basic": (dict(), None),
    "inactive": (dict(active_frac=0.7), None),
    "periodic": (dict(n=40, spread=1.4), 2.0),
    # n > TILE_J = 512: more than one of the JAX kernel's key chunks.
    "n600": (dict(n=600, log_var=-4.5), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_pallas(case):
    kw, period = CASES[case]
    args, means, cov, active = make(**kw)
    want = jax_fused(args, means, cov, active, period)
    before = (ak.fwd_launches, ak.bwd_launches)
    got = ak.aggregate_neighbors_fused(
        *(torch.from_numpy(args[k]) for k in NAMES), torch.from_numpy(means),
        torch_radii(cov, active), period=period)
    assert (ak.fwd_launches, ak.bwd_launches) == before  # the CPU twin
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    mask = ak.kernel_mask(torch.from_numpy(means), torch_radii(cov, active),
                          period=period)
    lonely = ~mask.any(dim=1)
    assert bool((got[lonely] == 0).all())  # rows with no neighbour: exactly 0
    if active is not None:
        assert lonely[torch.from_numpy(~active)].all()
    assert 0 < int(mask.sum()) < mask.numel()


@pytest.mark.parametrize("period", [None, 2.0])
def test_gradients_match_pallas(period):
    """All six inputs and the means, torch autograd through the Function's
    backward twin against jax.grad through the Pallas custom_vjp."""
    args, means, cov, active = make(n=50, active_frac=0.8,
                                    spread=1.4 if period else 1.0)
    radii = jpa.radii_of(jnp.asarray(cov), jnp.asarray(active))

    def loss(*xs):
        out = jpa.aggregate_neighbors_pallas(*xs, radii, period=period)
        return jnp.sum(out ** 2)

    inputs = [jnp.asarray(args[k]) for k in NAMES] + [jnp.asarray(means)]
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=tuple(range(7)))(*inputs)
    tin = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs]
    out = ak.aggregate_neighbors_fused(*tin, torch_radii(cov, active),
                                       period=period)
    got = torch.autograd.grad(torch.sum(out ** 2), tin)
    for name, a, b in zip(NAMES + ("means",), got, want):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / scale, b / scale,
                                   atol=1e-4 if name == "means" else 5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("with_active", [False, True])
def test_radii_of_matches_jax(with_active):
    _, _, cov, active = make(n=30, active_frac=0.6)
    active = active if with_active else None
    want = np.asarray(jpa.radii_of(
        jnp.asarray(cov), None if active is None else jnp.asarray(active)))
    got = torch_radii(cov, active).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got).any() == with_active


def test_kernel_mask_rule():
    """dist^2 <= cut^2, cut > 0 and no self-pair: an inactive Gaussian
    (radius -inf) joins no pair, and a radius of 0 still joins pairs within
    sigma_cut times the other radius."""
    means = torch.tensor([[0.0, 0.0], [0.5, 0.0], [0.0, 0.25], [0.1, 0.1]])
    radii = torch.tensor([0.1, 0.1, 0.0, -math.inf])
    mask = ak.kernel_mask(means, radii, sigma_cut=3.0)
    want = torch.tensor([[False, True, True, False],
                         [True, False, False, False],
                         [True, False, False, False],
                         [False, False, False, False]])
    assert torch.equal(mask, want)


def test_gradcheck_float64():
    """torch.autograd.gradcheck of the Function (twins on the CPU) in
    float64, every differentiable input at once."""
    args, means, cov, active = make(n=12, L=4, K=3, F=2, log_var=-4.0,
                                    spread=1.4)
    tin = [torch.from_numpy(args[k]).double().requires_grad_()
           for k in NAMES] + [torch.from_numpy(means).double()
                              .requires_grad_()]
    radii = torch_radii(cov, active).double()
    assert 0 < int(ak.kernel_mask(tin[6], radii, period=2.0).sum()) < 12 * 11

    def fn(*xs):
        return ak.aggregate_neighbors_fused(*xs, radii, period=2.0)
    assert torch.autograd.gradcheck(fn, tin, eps=1e-6, atol=1e-6)


def test_plain_impl_matches_the_function():
    args, means, cov, active = make(n=20, active_frac=0.8)
    xs = [torch.from_numpy(args[k]) for k in NAMES] + [
        torch.from_numpy(means), torch_radii(cov, active)]
    fused = ak.aggregate_neighbors_fused(*xs)
    plain = ak.aggregate_neighbors_fused(*xs, impl="plain")
    torch.testing.assert_close(fused, plain, rtol=0, atol=0)
    dense = tagg.aggregate_neighbors(
        *xs[:7], mask=ak.kernel_mask(xs[6], xs[7]))
    torch.testing.assert_close(fused, dense, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["d3", "impl"])
def test_raises(bad):
    args, means, cov, _ = make(n=10)
    xs = [torch.from_numpy(args[k]) for k in NAMES]
    radii = torch_radii(cov, None)
    if bad == "d3":
        with pytest.raises(ValueError, match="d=2"):
            ak.aggregate_neighbors_fused(*xs, torch.zeros(10, 3), radii)
    else:
        with pytest.raises(ValueError, match="impl"):
            ak.aggregate_neighbors_fused(*xs, torch.from_numpy(means), radii,
                                         impl="pallas")


# ------------------------------------------------- K4's grid and its merge ----

SMS = 132   # an H100 SXM


def slice_keys(n, slices):
    """The keys of each K4 slice: slice s takes the 32-key chunks s,
    s + slices, s + 2 slices, ..."""
    unit = ak.KEY_SLICE_UNIT
    return [[j for c in range(s, -(-n // unit), slices)
             for j in range(c * unit, min(n, (c + 1) * unit))]
            for s in range(slices)]


def assert_keys_covered(n, slices, slice_len):
    keys = slice_keys(n, slices)
    assert sorted(j for run in keys for j in run) == list(range(n))
    assert all(0 < len(run) <= slice_len for run in keys)
    assert slices == 1 or slice_len % ak.KEY_SLICE_UNIT == 0


@pytest.mark.parametrize("n", [640, 1664, 4096, 8192, 512, 1, 31, 33, 1000,
                               65536])
def test_fwd_geometry_covers_rows_and_keys(n):
    tiles, slices, slice_len = ak.fwd_geometry(n, SMS)
    assert tiles * ak.WARPS >= n and (tiles - 1) * ak.WARPS < n
    assert_keys_covered(n, slices, slice_len)


@pytest.mark.parametrize("n,want", [(640, (160, 5, 128)),
                                    (1664, (416, 2, 832))])
def test_fwd_geometry_fills_the_card_at_the_models_sizes(n, want):
    # NS (capacity 640) and the flagship (1664): about 6 blocks per SM.
    tiles, slices, slice_len = ak.fwd_geometry(n, SMS)
    assert (tiles, slices, slice_len) == want
    assert tiles * slices >= 2 * SMS


@pytest.mark.parametrize("n", [4096, 8192])
def test_fwd_geometry_one_slice_when_the_rows_fill_the_card(n):
    assert ak.fwd_geometry(n, SMS) == (n // ak.WARPS, 1, n)


@pytest.mark.parametrize("blocks_per_sm", [2, 4, 6, 8])
@pytest.mark.parametrize("n", [640, 1664])
def test_fwd_geometry_aims_at_the_target_given(n, blocks_per_sm):
    tiles, slices, slice_len = ak.fwd_geometry(n, SMS, blocks_per_sm)
    assert_keys_covered(n, slices, slice_len)
    assert (tiles * slices >= blocks_per_sm * SMS
            or slice_len == ak.KEY_SLICE_UNIT)


def slice_records(x, slices, period):
    """K4's per-slice records, float64 torch: for each slice's keys, every
    row's max logit over its neighbours there (-inf when none), the sum of
    exp(logit - max) and acc_l = sum_j exp(logit_ij - max) mapped_jl
    gate_ijl."""
    f, tr, q, k, fr, dist, means, radii = x
    n = f.shape[0]
    mask = ak.kernel_mask(means, radii, 3.0, period)
    mapped = f @ tr.T
    rel = tagg._wrap(means[None, :, :] - means[:, None, :], period)
    emb = torch.cat([tagg.positional_embedding(rel, fr),
                     tagg.positional_embedding(2.0 * rel, fr)], dim=-1)
    gate = torch.einsum("ijE,lE->ijl", emb, dist)
    logits = q @ k.T / math.sqrt(q.shape[1])
    records = []
    for keys in slice_keys(n, slices):
        nb = mask[:, keys]
        lg = logits[:, keys].masked_fill(~nb, -math.inf)
        top = lg.max(dim=1).values
        p = torch.zeros_like(lg)
        p[nb] = torch.exp(lg - top[:, None])[nb]
        acc = torch.einsum("ij,jl,ijl->il", p, mapped[keys], gate[:, keys])
        records.append((top, p.sum(dim=1), acc, nb.any(dim=1)))
    return records


def merge_records(records):
    """K4's merge pass in slice order: the slices with a neighbour rescaled
    to their common max; 0 for a row with none in any slice."""
    top = torch.full_like(records[0][0], -math.inf)
    for m, s, _, _ in records:
        live = s > 0
        top[live] = torch.maximum(top[live], m[live])
    num = torch.zeros_like(records[0][2])
    den = torch.zeros_like(records[0][1])
    for m, s, acc, _ in records:
        live = s > 0
        e = torch.exp(m[live] - top[live])   # never -inf - -inf
        num[live] += e[:, None] * acc[live]
        den[live] += e * s[live]
    out = torch.zeros_like(num)
    out[den > 0] = num[den > 0] / den[den > 0, None]
    return out


@pytest.mark.parametrize("slices", [1, 2, 3])
@pytest.mark.parametrize("period", [None, 2.0])
def test_slice_merge_equals_the_twin(slices, period):
    """The merge K4 runs over its key slices, in float64, against the plain
    twin: equal within 1e-12, with a row that has no neighbour in any slice
    and rows with no neighbour in some slice."""
    args, means, cov, active = make(n=130, log_var=-6.0, active_frac=0.8,
                                    spread=1.4 if period else 1.0)
    order = np.argsort(means[:, 0])   # each key chunk then a strip in x
    x = [torch.from_numpy(args[k]).double() for k in NAMES] + [
        torch.from_numpy(means[order]).double(),
        torch_radii(cov[order], active[order]).double()]
    records = slice_records(x, slices, period)
    got = merge_records(records)
    want = ak.aggregate_fused_plain(*x, period=period)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    reached = torch.stack([r[3] for r in records], dim=1)   # (rows, slices)
    lonely = ~reached.any(dim=1)
    assert bool(lonely.any()) and bool((got[lonely] == 0).all())
    if len(records) > 1:
        assert bool((~reached & reached.any(dim=1, keepdim=True)).any())
