"""The launch geometry of the mixture kernels K1, K2 and K3 (CPU).

K1 (``mixture_fwd.cu``) and K3 (``mixture_bwd.cu``, sample side) run a grid
of sample tiles x Gaussian slices, both from ``fwd_geometry``, and K2
(``mixture_bwd.cu``, Gaussian side) a grid of Gaussian tiles x sample slices
from ``gauss_geometry``; the kernels mask the ragged edges.  These tests hold the helpers to what the
kernels rely on: the tiles and slices cover both axes exactly, every slice
but the last is a whole number of slice units, and at the main path's
shapes the grid puts at least two blocks on each of an H100's 132 SMs.
"""

import pytest

from pigs_tpu_torch.ops import mixture_kernel as mk

SMS = 132   # an H100 SXM

# (m samples, n Gaussians) as the paths call K1 (the grid depends on m and
# n alone): the flagship at the means (order 2; order 0 for the split's
# density and value) and at the collocation / boundary / render samples
# (orders 2 and 0), Navier-Stokes at its means (order 3, c=2) and its 64x64
# vorticity render (order 1, c=2).
K1_SHAPES = {"1664x1664 order 2": (1664, 1664),
             "1664x1664 order 0": (1664, 1664),
             "4096x1664 order 2": (4096, 1664),
             "4096x1664 order 0": (4096, 1664),
             "NS 640x640 order 3": (640, 640),
             "NS 4096x640 order 1": (4096, 640)}
# K2 at the two training calls: collocation (order 2) and boundary (order 0).
K2_SHAPES = {"4096x1664 order 2": (4096, 1664),
             "4096x1664 order 0": (4096, 1664)}
# K3 runs on no path; the card times it at K2's two training shapes.
K3_SHAPES = dict(K2_SHAPES)
# Ragged, tiny, empty and large cases besides.
OTHER_SHAPES = [(1000, 333), (1, 1), (0, 5), (5, 0), (130, 5000), (257, 9),
                (65536, 2048), (129, 131)]


def _runs(length, slices, slice_len):
    """The index runs the kernels take: slice s covers [s*len, (s+1)*len)
    cut at ``length``."""
    return [range(s * slice_len, min(length, (s + 1) * slice_len))
            for s in range(slices)]


def _assert_covers(length, slices, slice_len, unit):
    runs = _runs(length, slices, slice_len)
    assert [i for r in runs for i in r] == list(range(length))
    assert all(len(r) > 0 for r in runs) or length == 0
    if slices > 1:
        assert slice_len % unit == 0
        assert all(len(r) == slice_len for r in runs[:-1])


def _assert_tiles_cover(length, tiles):
    assert tiles * mk.THREADS >= length
    assert (tiles - 1) * mk.THREADS < max(length, 1)


@pytest.mark.parametrize("m,n", list(K1_SHAPES.values()) + OTHER_SHAPES)
def test_fwd_geometry_covers_both_axes(m, n):
    tiles, slices, slice_len = mk.fwd_geometry(m, n, SMS)
    _assert_tiles_cover(m, tiles)
    _assert_covers(n, slices, slice_len, mk.FWD_SLICE_UNIT)


@pytest.mark.parametrize("m,n", list(K2_SHAPES.values()) + OTHER_SHAPES)
def test_gauss_geometry_covers_both_axes(m, n):
    tiles, slices, slice_len = mk.gauss_geometry(m, n, SMS)
    _assert_tiles_cover(n, tiles)
    _assert_covers(m, slices, slice_len, mk.BWD_SLICE_UNIT)


# kernel -> (geometry helper, shapes by label, slice unit)
GEOMETRY = {"K1": (mk.fwd_geometry, K1_SHAPES, mk.FWD_SLICE_UNIT),
            "K2": (mk.gauss_geometry, K2_SHAPES, mk.BWD_SLICE_UNIT),
            "K3": (mk.fwd_geometry, K3_SHAPES, mk.FWD_SLICE_UNIT)}


@pytest.mark.parametrize("kernel,label",
                         [("K1", k) for k in K1_SHAPES]
                         + [("K2", k) for k in K2_SHAPES]
                         + [("K3", k) for k in K3_SHAPES])
def test_main_path_grids_fill_the_card(kernel, label):
    geometry, shapes, _ = GEOMETRY[kernel]
    tiles, slices, _ = geometry(*shapes[label], SMS)
    assert tiles * slices >= 2 * SMS


def test_one_slice_when_the_tiles_fill_the_card():
    # 65536 samples are 512 tiles: two slices reach BLOCKS_PER_SM = 6 per
    # SM; 6 tiles per SM need no split at all.
    assert mk.BLOCKS_PER_SM == 6
    assert mk.fwd_geometry(65536, 2048, SMS) == (512, 2, 1024)
    m = 6 * SMS * mk.THREADS
    assert mk.fwd_geometry(m, 2048, SMS) == (6 * SMS, 1, 2048)


def test_k3_grid_at_the_training_shape():
    # K3 takes K1's grid: 32 sample tiles x 26 Gaussian slices of 64 at
    # 4096x1664, 832 blocks (its first design ran 32).
    assert mk.fwd_geometry(4096, 1664, SMS) == (32, 26, 64)


@pytest.mark.parametrize("kernel,m,n", [("K1", 1000, 5), ("K1", 1, 8),
                                        ("K2", 20, 333), ("K2", 32, 1),
                                        ("K3", 1000, 5), ("K3", 4096, 8)])
def test_a_short_summed_axis_takes_one_slice(kernel, m, n):
    # The main pass then writes the outputs itself (no combine pass); the
    # card checks this branch at K1 and K3 1000x5 and K2 20x333.
    geometry = GEOMETRY[kernel][0]
    tiles, slices, slice_len = geometry(m, n, SMS)
    assert slices == 1
    assert slice_len >= (m if kernel == "K2" else n)


@pytest.mark.parametrize("blocks_per_sm", [2, 4, 6, 8])
@pytest.mark.parametrize("kernel,label",
                         [("K1", k) for k in K1_SHAPES]
                         + [("K2", k) for k in K2_SHAPES]
                         + [("K3", k) for k in K3_SHAPES])
def test_grid_aims_at_the_target_given(kernel, label, blocks_per_sm):
    # The targets the card times against each other: each grid covers both
    # axes and reaches the target unless the slices are down to one unit.
    geometry, shapes, unit = GEOMETRY[kernel]
    m, n = shapes[label]
    tiles, slices, slice_len = geometry(m, n, SMS, blocks_per_sm)
    tiled, summed = (n, m) if kernel == "K2" else (m, n)
    _assert_tiles_cover(tiled, tiles)
    _assert_covers(summed, slices, slice_len, unit)
    assert tiles * slices >= blocks_per_sm * SMS or slice_len == unit
