"""Host-side functions copied into indigo_tpu_torch are array-equal to the
reference's, so the copies cannot drift."""
import numpy as np
import pytest

from indigo_tpu import noncart as jnc
from indigo_tpu.ops import dft_fft as jdft
from indigo_tpu.ops import tile_interp as jti
from indigo_tpu_torch import noncart as tnc
from indigo_tpu_torch.ops import dft_fft as tdft
from indigo_tpu_torch.ops import tile_interp as tti


def _traj(rng, M, d):
    return rng.uniform(-0.5, 0.5, size=(M, d))


def test_default_tiles_equal():
    assert tnc.DEFAULT_TILES == jnc.DEFAULT_TILES


@pytest.mark.parametrize("grid,tile", [((32, 32), (8, 16)),
                                       ((16, 16, 16), (4, 4, 8))])
def test_tiled_order_equal(grid, tile):
    np.testing.assert_array_equal(tnc.tiled_order(grid, tile),
                                  jnc.tiled_order(grid, tile))


def test_kaiser_bessel_and_beta_equal():
    t = np.linspace(-2.5, 2.5, 101)
    for width, os_ in ((4, 1.25), (5, 2.0)):
        beta = tnc.beatty_beta(width, os_)
        assert beta == jnc.beatty_beta(width, os_)
        np.testing.assert_array_equal(tnc.kaiser_bessel(t, width, beta),
                                      jnc.kaiser_bessel(t, width, beta))


@pytest.mark.parametrize("d,tile", [(2, None), (3, None), (3, (4, 4, 8))])
def test_sort_trajectory_equal(rng, d, tile):
    traj = _traj(rng, 500, d)
    grid = (40,) * d
    np.testing.assert_array_equal(
        tnc.sort_trajectory(traj, grid, tile=tile),
        jnc.sort_trajectory(traj, grid, tile=tile))


@pytest.mark.parametrize("d", [2, 3])
def test_interp_mat_equal(rng, d):
    traj = _traj(rng, 300, d)
    grid = (20,) * d
    a = tnc.interp_mat(traj, grid, width=4, impl="numpy")
    b = jnc.interp_mat(traj, grid, width=4, impl="numpy")
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_deapodization_and_checkerboard_equal():
    np.testing.assert_array_equal(
        tnc.deapodization((16, 12, 8), (20, 16, 10), width=4, beta=7.0),
        jnc.deapodization((16, 12, 8), (20, 16, 10), width=4, beta=7.0))
    np.testing.assert_array_equal(tnc._apod_1d(40, 32, 4, 7.0),
                                  jnc._apod_1d(40, 32, 4, 7.0))
    for shifted in (False, True):
        np.testing.assert_array_equal(
            tnc.checkerboard((6, 10), shifted=shifted),
            jnc.checkerboard((6, 10), shifted=shifted))


# (grid, width): periodic 3D, periodic 2D, and a non-periodic halo grid
@pytest.mark.parametrize("grid,width", [((40, 40, 40), 4), ((48, 48), 5),
                                        ((20, 20, 20), 4)])
def test_plan_tile_interp_equal(rng, grid, width):
    traj = _traj(rng, 400, len(grid))
    a = tti.plan_tile_interp(traj, grid, width=width, beta=6.5,
                             reorder=True)
    b = jti.plan_tile_interp(traj, grid, width=width, beta=6.5,
                             adjoint="scatter", reorder=True)
    np.testing.assert_array_equal(a.tid, np.asarray(b.tid))
    for wa, wb in zip(a.wfac, b.wfac):
        np.testing.assert_array_equal(wa, np.asarray(wb))
    assert b.sample_perm is not None
    np.testing.assert_array_equal(a.sample_perm, b.sample_perm)
    for k in ("grid_shape", "tile", "ext", "nt", "pad_lo", "width"):
        assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("n", [8, 24, 136])
def test_dft_pad2x_mats_equal(n):
    for x, y in zip(tdft.dft_pad2x_mats(n), jdft.dft_pad2x_mats(n)):
        np.testing.assert_array_equal(x, y)


def test_block_spectrum_equal(rng):
    Tf = rng.standard_normal((16, 12, 8)).astype(np.float32)
    np.testing.assert_array_equal(tdft.block_spectrum(Tf),
                                  jdft.block_spectrum(Tf))
    np.testing.assert_array_equal(tdft.block_perm(12), jdft.block_perm(12))


@pytest.mark.parametrize("n,g", [(16, 20), (24, 48), (7, 12)])
def test_centered_pad_dft_mat_equal(n, g):
    np.testing.assert_array_equal(tdft.centered_pad_dft_mat(n, g),
                                  jdft.centered_pad_dft_mat(n, g))


def test_tiled_idft_mats_equal():
    a = tdft.tiled_idft_mats((16, 16, 16), (40, 40, 40), (4, 4, 8))
    b = jdft.tiled_idft_mats((16, 16, 16), (40, 40, 40), (4, 4, 8))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
