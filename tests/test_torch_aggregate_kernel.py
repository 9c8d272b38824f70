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


# --------------------------------------- K5's grid and its decomposition ----
#
# K5 runs three passes over pairs on K4's grid (fwd_geometry): statistics
# and a row pass over (row tile, key slice), a column pass over (column
# tile, row slice), each followed by a merge of the slices in slice order;
# gW_d and gfreq come from per-block partials of the row pass, gW_t from
# per-block partials of the column merge, each reduced in two levels.

K5_SIZES = [1, 31, 33, 512, 640, 1000, 1664, 4096, 8192]
REDUCE_RUNS = 16        # aggregate_bwd.cu: kReduceRuns
MERGE_BLOCKS = 264      # aggregate_bwd.cu: kMaxMergeBlocks


@pytest.mark.parametrize("blocks_per_sm", [2, 4, 6, 8])
@pytest.mark.parametrize("n", K5_SIZES)
def test_bwd_grid_visits_every_pair_once_per_pass(n, blocks_per_sm):
    """K5's launcher takes fwd_geometry at the sweep's targets; in each of
    its passes every (row, key) -- in the column pass, with the axes
    swapped, every (column, row) -- falls to exactly one warp: the tiles
    of 4 cover the first axis once and the dealt slices the second.  At
    the models' sizes the grid meets the target (or the slices are one
    chunk each) and puts at least 2 blocks on every SM."""
    tiles, slices, slice_len = ak.fwd_geometry(n, SMS, blocks_per_sm)
    assert tiles * ak.WARPS >= n > (tiles - 1) * ak.WARPS
    assert_keys_covered(n, slices, slice_len)
    seen = torch.zeros(n, dtype=torch.long)
    for run in slice_keys(n, slices):
        seen[run] += 1
    assert bool((seen == 1).all())
    if n in (640, 1664):
        assert (tiles * slices >= blocks_per_sm * SMS
                or slice_len == ak.KEY_SLICE_UNIT)
        assert tiles * slices >= 2 * SMS


@pytest.mark.parametrize("period", [None, 2.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_mask_is_symmetric(period, seed):
    """K5's column pass finds the rows i of column j by the row pass's own
    test on rel_ij; the mask it walks is the same as the transposed mask
    only because the rule is symmetric in float32, wrap included."""
    args, means, cov, active = make(n=130, log_var=-6.0 + 2 * seed,
                                    active_frac=0.8,
                                    spread=1.4 if period else 1.0, seed=seed)
    mask = ak.kernel_mask(torch.from_numpy(means), torch_radii(cov, active),
                          period=period)
    assert torch.equal(mask, mask.T)
    assert 0 < int(mask.sum()) < mask.numel() - mask.shape[0]


def two_level(partials):
    """The reduce kernel's order: REDUCE_RUNS runs of the blocks, each
    summed in block order, then the runs in order."""
    b = partials.shape[0]
    total = torch.zeros_like(partials[0])
    for r in range(REDUCE_RUNS):
        run = torch.zeros_like(partials[0])
        for k in range(r * b // REDUCE_RUNS, (r + 1) * b // REDUCE_RUNS):
            run = run + partials[k]
        total = total + run
    return total


def pair_terms(x, cot, period):
    """Dense float64 per-pair quantities of K5: the mask, logits, the gate
    (i, j, l), its derivatives in rel (i, j, l, 2) and in the frequencies
    (i, j, l, F), the embedding (i, j, 2E) and mapped."""
    f, tr, q, k, fr, dist, means, radii = x
    L, F = dist.shape[0], fr.shape[0]
    E = dist.shape[1] // 2
    mask = ak.kernel_mask(means, radii, 3.0, period)
    rel = tagg._wrap(means[None, :, :] - means[:, None, :], period)
    emb = torch.cat([tagg.positional_embedding(rel, fr),
                     tagg.positional_embedding(2.0 * rel, fr)], dim=-1)
    gate = torch.einsum("ijE,lE->ijl", emb, dist)
    drel = torch.zeros(*rel.shape[:2], L, 2, dtype=rel.dtype)
    dfreq = torch.zeros(*rel.shape[:2], L, F, dtype=rel.dtype)
    for o, scale in enumerate((1.0, 2.0)):
        theta = scale * rel[:, :, None, :] * fr[None, None, :, None]  # i j k a
        ws = dist[:, o * E + 1:o * E + 1 + 2 * F].reshape(L, F, 2)
        wc = dist[:, o * E + 1 + 2 * F:(o + 1) * E].reshape(L, F, 2)
        u = (torch.cos(theta)[:, :, None] * ws
             - torch.sin(theta)[:, :, None] * wc)              # i j l k a
        drel += scale * torch.einsum("ijlka,k->ijla", u, fr)
        dfreq += scale * torch.einsum("ijlka,ija->ijlk", u, rel)
    logits = q @ k.T / math.sqrt(q.shape[1])
    return mask, logits, gate, drel, dfreq, emb, f @ tr.T


def bwd_decomposition(x, cot, slices, period):
    """K5's passes in float64: statistics records and their merge, row
    records and the row merge, column records and the column merge, and
    the block-order reductions; the seven gradients in
    aggregate_fused_backward_plain's order."""
    f, tr, q, k, fr, dist, means, radii = x
    n = f.shape[0]
    mask, logits, gate, drel, dfreq, emb, mapped = pair_terms(x, cot, period)
    groups = slice_keys(n, slices)

    # Statistics: (max, sum) per (slice, row), merged in slice order.
    stat = []
    for keys in groups:
        nb = mask[:, keys]
        lg = logits[:, keys].masked_fill(~nb, -math.inf)
        top = lg.max(dim=1).values
        s = torch.where(nb, torch.exp(lg - top[:, None]),
                        torch.zeros_like(lg)).sum(dim=1)
        stat.append((top, s))
    top = torch.full((n,), -math.inf, dtype=f.dtype)
    for m, s in stat:
        top = torch.where(s > 0, torch.maximum(top, m), top)
    den = torch.zeros(n, dtype=f.dtype)
    for m, s in stat:
        live = s > 0
        den[live] += torch.exp(m[live] - top[live]) * s[live]
    top = torch.where(den > 0, top, torch.zeros_like(top))
    alpha = torch.zeros_like(logits)
    alpha[mask] = (torch.exp(logits - top[:, None])
                   / den[:, None].clamp_min(1e-300))[mask]

    dalpha = torch.einsum("il,jl,ijl->ij", cot, mapped, gate)
    ggate = alpha[:, :, None] * cot[:, None, :] * mapped[None, :, :]
    grel = torch.einsum("ijl,ijla->ija", ggate, drel)

    # Row pass: per (slice, row) D, a1, a2 and the i-side grel; per block
    # (tile of 4 rows, slice) the partials of gW_d and gfreq.
    row_rec = []
    blocks = []
    tiles = -(-n // ak.WARPS)
    for keys in groups:
        a, da = alpha[:, keys], dalpha[:, keys]
        row_rec.append(((a * da).sum(1), (a * da) @ k[keys], a @ k[keys],
                        grel[:, keys].sum(1)))
        for t in range(tiles):
            rows = slice(t * ak.WARPS, (t + 1) * ak.WARPS)
            gg = ggate[rows][:, keys]
            blocks.append(torch.cat([
                torch.einsum("ijl,ijE->lE", gg, emb[rows][:, keys]).flatten(),
                torch.einsum("ijl,ijlk->k", gg, dfreq[rows][:, keys])]))
    d_row = sum(r[0] for r in row_rec)
    gq = (sum(r[1] for r in row_rec)
          - d_row[:, None] * sum(r[2] for r in row_rec)) / math.sqrt(
              q.shape[1])
    gmi = -sum(r[3] for r in row_rec)
    weights = two_level(torch.stack(blocks))
    L, E2 = dist.shape
    gdist, gfreq = weights[:L * E2].reshape(L, E2), weights[L * E2:]

    # Column pass: per (slice of rows, column) gk, gm and the j-side grel,
    # from the merged (max, sum, D) of each neighbour row.
    dlogit = alpha * (dalpha - d_row[:, None])
    col_rec = []
    for rows in groups:
        col_rec.append((dlogit[rows].T @ q[rows],
                        torch.einsum("ij,il,ijl->jl", alpha[rows], cot[rows],
                                     gate[rows]),
                        grel[rows].sum(0)))
    gk = sum(r[0] for r in col_rec) / math.sqrt(q.shape[1])
    gm = sum(r[1] for r in col_rec)
    gmeans = gmi + sum(r[2] for r in col_rec)

    # Column merge: gf = W_t^T gm, and gW_t from per-block partials (warp w
    # of block b takes columns b W + w, b W + w + B W, ...).
    merge_blocks = max(1, min(tiles, MERGE_BLOCKS))
    parts = []
    for b in range(merge_blocks):
        cols = [j for w in range(ak.WARPS)
                for j in range(b * ak.WARPS + w, n, merge_blocks * ak.WARPS)]
        parts.append(gm[cols].T @ f[cols])
    gtr = two_level(torch.stack(parts))
    return (gm @ tr, gtr, gq, gk, gfreq, gdist, gmeans), alpha, stat


@pytest.mark.parametrize("slices", [1, 2, 3])
@pytest.mark.parametrize("period", [None, 2.0])
def test_bwd_decomposition_equals_the_twin(slices, period):
    """K5's statistics, row and column passes with their slice merges and
    block-order reductions, in float64, against autograd through the plain
    twin: all seven gradients within 1e-12, with a row that has no
    neighbour in any slice (exact zeros) and rows with none in some."""
    args, means, cov, active = make(n=130, log_var=-6.0, active_frac=0.8,
                                    spread=1.4 if period else 1.0)
    order = np.argsort(means[:, 0])   # each chunk then a strip in x
    x = [torch.from_numpy(args[k]).double() for k in NAMES] + [
        torch.from_numpy(means[order]).double(),
        torch_radii(cov[order], active[order]).double()]
    cot = torch.from_numpy(np.random.default_rng(7).normal(
        size=(130, args["features"].shape[1])))
    got, alpha, stat = bwd_decomposition(x, cot, slices, period)
    want = ak.aggregate_fused_backward_plain(*x, cot, period=period)
    for name, a, b in zip(NAMES + ("means",), got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)
    reached = torch.stack([s > 0 for _, s in stat], dim=1)
    lonely = ~reached.any(dim=1)
    assert bool(lonely.any())
    assert bool((got[2][lonely] == 0).all())          # gq
    assert bool((alpha[lonely] == 0).all())
    assert bool(torch.isfinite(torch.cat([g.flatten() for g in got])).all())
    if slices > 1:
        assert bool((~reached & reached.any(dim=1, keepdim=True)).any())


class _FakeBwdLibrary:
    """Stands in for the built K5 library: records each call's arguments
    and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def pigs_aggregate_bwd_scratch(self, n, slices):
        return n * slices

    def pigs_aggregate_bwd(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.mark.parametrize("rc", [0, 2])
def test_launch_bwd_passes_the_grid_and_counts_launches(monkeypatch, rc):
    """_launch_bwd hands K5 fwd_geometry's slice count at the target,
    returns the seven gradients in the twin's shapes and order, counts one
    launch a call however many passes run, and raises (counting nothing)
    when the launch fails."""
    lib = _FakeBwdLibrary(rc)
    monkeypatch.setattr(ak, "_bwd_library", lambda: (lib, None))
    monkeypatch.setattr(ak, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(ak, "_stream", lambda dev: 0)
    args, means, cov, _ = make(n=1664, L=16, K=16)
    x = [torch.from_numpy(args[k]) for k in NAMES] + [
        torch.from_numpy(means), torch_radii(cov, None)]
    cot = torch.zeros(1664, 16)
    before = ak.bwd_launches
    if rc:
        with pytest.raises(RuntimeError, match="aggregate_bwd"):
            ak._launch_bwd(*x, cot, 3.0, 2.0)
        assert ak.bwd_launches == before
        return
    grads = ak._launch_bwd(*x, cot, 3.0, 2.0, blocks_per_sm=4)
    assert ak.bwd_launches == before + 1 and len(lib.calls) == 1
    call = lib.calls[0]
    assert call[0] == 1664 and call[10:14] == (3.0, 1, 2.0, ak.fwd_geometry(
        1664, SMS, 4)[1])
    assert [tuple(g.shape) for g in grads] == [
        (1664, 16), (16, 16), (1664, 16), (1664, 16), (6,), (16, 50),
        (1664, 2)]
    assert list(call[15:22]) == [g.data_ptr() for g in grads]
