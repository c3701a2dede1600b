"""Port's KB gridding and GridDFT vs the reference's on the same plan.

Tolerance 1e-5: the port scatters with index_add_ into the natural-order
grid, the reference through its tiled layout, so sums run in another order
(f32 rounding, not bitwise).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indigo_tpu.ops import tile_interp as jti
from indigo_tpu.operators import GridDFT as JGridDFT
from indigo_tpu_torch.operators import GridDFT, Diag, KronI, VStack
from indigo_tpu_torch.ops import tile_interp as tti
from indigo_tpu_torch.utils import rand64c, rel_err

# periodic 3D, periodic 2D, non-periodic (halo) 3D
CASES = [((40, 40, 40), 4), ((48, 48), 5), ((20, 20, 20), 4)]


def _plans(rng, grid, width, M=300):
    traj = rng.uniform(-0.5, 0.5, size=(M, len(grid)))
    tp = tti.plan_tile_interp(traj, grid, width=width, beta=6.5,
                              reorder=True)
    # the reference plan on the port's (reordered) sample order
    traj_s = traj if tp.sample_perm is None else traj[tp.sample_perm]
    jp = jti.plan_tile_interp(traj_s, grid, width=width, beta=6.5,
                              adjoint="scatter", forward="dense")
    return tp, jp


@pytest.mark.parametrize("grid,width", CASES)
def test_gridding_forward_matches(rng, grid, width):
    tp, jp = _plans(rng, grid, width)
    corner, wkb = (torch.from_numpy(a) for a in tti.kb_patches(tp))
    K = 2
    x = rand64c(K, *grid, rng=rng)
    ref = np.asarray(jti.tile_interp_apply(
        jp, jnp.asarray(x.reshape(K, -1).T)))
    out = tti.kb_gather(corner, wkb, grid, torch.from_numpy(x))
    assert rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("grid,width", CASES)
def test_gridding_adjoint_matches(rng, grid, width):
    tp, jp = _plans(rng, grid, width)
    corner, wkb = (torch.from_numpy(a) for a in tti.kb_patches(tp))
    y = rand64c(tp.n_samples, 3, rng=rng)
    ref = np.asarray(jti.tile_interp_apply(jp, jnp.asarray(y),
                                           adjoint=True))
    out = tti.kb_scatter(corner, wkb, grid, torch.from_numpy(y), chunk=64)
    assert rel_err(out.reshape(3, -1).T, ref) < 1e-5


@pytest.mark.parametrize("grid,width", CASES[:2])
def test_kb_patches_match_interp_mat(rng, grid, width):
    """The patches recovered from tid/wfac are the CSR's rows."""
    from indigo_tpu_torch.noncart import interp_mat
    traj = rng.uniform(-0.5, 0.5, size=(200, len(grid)))
    tp = tti.plan_tile_interp(traj, grid, width=width, beta=6.5)
    corner, wkb = (torch.from_numpy(a) for a in tti.kb_patches(tp))
    G = interp_mat(traj, grid, width=width, beta=6.5).toarray()
    eye = torch.eye(tp.n_samples, dtype=torch.complex64)
    rows = tti.kb_scatter(corner, wkb, grid, eye)
    assert rel_err(rows.reshape(tp.n_samples, -1).numpy(), G) < 1e-6


def _grid_dft_pair(rng, img, oversamp, M=250):
    grid = tuple(int(2 * round(n * oversamp / 2)) for n in img)
    traj = rng.uniform(-0.5, 0.5, size=(M, len(img)))
    tp = tti.plan_tile_interp(traj, grid, width=4, beta=6.5)
    jp = jti.plan_tile_interp(traj, grid, width=4, beta=6.5)
    return GridDFT(tp, img, device="cpu"), JGridDFT(jp, img)


@pytest.mark.parametrize("img,oversamp", [((16, 16, 16), 2.0),
                                          ((24, 24), 2.0)])
def test_grid_dft_matches_reference(rng, img, oversamp):
    A, J = _grid_dft_pair(rng, img, oversamp)
    x = rand64c(int(np.prod(img)), 2, rng=rng)
    ref = np.asarray(J.apply(jnp.asarray(x)))
    out = A.apply(torch.from_numpy(x))
    assert rel_err(out, ref) < 1e-5
    y = rand64c(A.shape[0], 2, rng=rng)
    ref = np.asarray(J.apply(jnp.asarray(y), adjoint=True))
    out = A.H.apply(torch.from_numpy(y))
    assert rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("img,oversamp", [((16, 16, 16), 2.0),
                                          ((24, 24), 2.0)])
def test_sense_chain_adjointness(rng, img, oversamp):
    A, _ = _grid_dft_pair(rng, img, oversamp)
    n = int(np.prod(img))
    maps = rand64c(2, n, rng=rng)
    S = KronI(2, A) * VStack([Diag(m, device="cpu") for m in maps])
    x = torch.from_numpy(rand64c(n, 1, rng=rng))
    y = torch.from_numpy(rand64c(S.shape[0], 1, rng=rng))
    lhs = torch.vdot(y[:, 0], (S * x)[:, 0])
    rhs = torch.vdot(S.H.apply(y)[:, 0], x[:, 0])
    assert abs(complex(lhs - rhs)) / abs(complex(lhs)) < 1e-5
    fl, by = S.cost(1)
    assert fl > 0 and by > 0


def test_grid_dft_requires_periodic_tiling(rng):
    traj = rng.uniform(-0.5, 0.5, size=(50, 3))
    tp = tti.plan_tile_interp(traj, (20, 20, 20), width=4)
    with pytest.raises(ValueError, match="periodic"):
        GridDFT(tp, (16, 16, 16), device="cpu")
