"""The 2D radial sparse-gridding CG-SENSE recipe: the port vs the reference.

``sense_nufft_op(..., interp="sparse")`` at 32^2 and 48^2 with 4 coils
(the radial geometry of ``examples/radial_sense_2d.py``): operator,
adjoint and sample permutation at 1e-5, with and without the Morton column
re-tiling (``col_tiling``); then ``cg`` on A^H A against
``indigo_tpu.solvers.cg`` at 1e-4 (the bar of tests/test_torch_cg.py).
Both packages grid on the builder the test pins (tests/test_torch_native.py):
the solves on each of the two, the operators on the native one.
"""
import numpy as np
import pytest
import torch

import indigo_tpu as jit_
from indigo_tpu.models import sense_nufft_op as j_sense_nufft_op
from indigo_tpu_torch import cg
from indigo_tpu_torch.models.sense import nufft_op, sense_nufft_op
from indigo_tpu_torch.operators import Perm, SpMatrix
from indigo_tpu_torch.sparse import BlockedJag
from indigo_tpu_torch.utils import rand64c, rel_err

from test_torch_native import BUILDERS, builder  # noqa: F401


def radial_traj(nspokes, nread):
    ang = np.pi * np.arange(nspokes) / nspokes
    r = (np.arange(nread) - nread // 2) / nread
    return np.stack([np.outer(np.cos(ang), r).ravel(),
                     np.outer(np.sin(ang), r).ravel()], axis=1)


def smooth_maps(nc, n, rng):
    yy, xx = np.mgrid[0:n, 0:n] / n
    maps = []
    for _ in range(nc):
        a, b, c, d = rng.random(4)
        amp = 0.4 + np.exp(-((xx - a) ** 2 + (yy - b) ** 2) * 3)
        maps.append(amp * np.exp(2j * np.pi * (c * xx + d * yy)))
    return np.asarray(maps, dtype=np.complex64)


def _problem(n, nc=4, col_tiling=None, seed=0):
    rng = np.random.default_rng(seed)
    traj = radial_traj(int(1.5 * n), 2 * n)
    maps = smooth_maps(nc, n, rng)
    kw = dict(oversamp=1.5, width=4, interp="sparse", col_tiling=col_tiling)
    Aj, pj = j_sense_nufft_op(traj, maps, **kw)
    At, pt = sense_nufft_op(traj, maps, device="cpu", **kw)
    return rng, Aj, pj, At, pt


def _leaves(A, cls):
    return [m for m in A.modules() if isinstance(m, cls)]


@pytest.mark.parametrize("n", [32, 48])
@pytest.mark.parametrize("col_tiling", [None, True, False])
def test_sparse_sense_op_matches_reference(n, col_tiling, builder):
    rng, Aj, pj, At, pt = _problem(n, col_tiling=col_tiling)
    np.testing.assert_array_equal(pt.perm, pj.perm)
    np.testing.assert_allclose(pt.traj, pj.traj)
    assert pt.grid_shape == pj.grid_shape
    (G,) = _leaves(At, SpMatrix)
    assert isinstance(G.ell, BlockedJag)
    tileable = all(g % t == 0 for g, t in zip(pt.grid_shape, (8, 16)))
    assert len(_leaves(At, Perm)) == int(col_tiling is not False
                                         and tileable)
    x = rand64c(n * n, 2, rng=rng)
    y = rand64c(At.shape[0], 2, rng=rng)
    assert rel_err(At * torch.from_numpy(x), np.asarray(Aj * x)) < 1e-5
    assert rel_err(At.H * torch.from_numpy(y), np.asarray(Aj.H * y)) < 1e-5


def test_col_tiling_permutation_matches_reference(builder):
    """The GridTiling leaf and the tiled CSR columns: same permutation, same
    block layout, and KB weights equal to f32 rounding (the reference's
    interp_mat may come from its native C++ gridding code, which rounds in
    another order)."""
    traj = radial_traj(48, 64)
    j_op, _ = jit_.models.nufft_op(traj, (32, 32), interp="sparse")
    t_op, _ = nufft_op(traj, (32, 32), interp="sparse", device="cpu")
    (jp,) = [o for o in _walk(j_op) if isinstance(o, jit_.Perm)]
    (tp,) = _leaves(t_op, Perm)
    np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(jp.perm))
    (jg,) = [o for o in _walk(j_op) if isinstance(o, jit_.SpMatrix)]
    (tg,) = _leaves(t_op, SpMatrix)
    np.testing.assert_allclose(tg.ell.data.numpy(), np.asarray(jg.ell.data),
                               rtol=0, atol=1e-7)
    for name in ("bcols", "brows"):
        np.testing.assert_array_equal(getattr(tg.ell, name).numpy(),
                                      np.asarray(getattr(jg.ell, name)))


def _walk(op):
    yield op
    for c in op.children():
        yield from _walk(c)


def _rhs(Aj, n, rng):
    yy, xx = np.mgrid[0:n, 0:n] / n
    x_true = (((xx - .5) / .35) ** 2 + ((yy - .5) / .45) ** 2 <= 1).astype(
        np.complex64).ravel()
    y = np.asarray(Aj * x_true)
    sigma = 0.01 * np.sqrt(np.mean(np.abs(y) ** 2) / 2)
    y = (y + sigma * rand64c(len(y), rng=rng)).astype(np.complex64)
    return np.array(Aj.H * y)


def _lamda(At, n, rng):
    """0.3 x the largest eigenvalue of A^H A (power iteration): a CG whose
    10 f32 steps stay well conditioned, so two packages summing in another
    order agree to 1e-6 rather than amplifying the rounding."""
    v = torch.from_numpy(rand64c(n * n, rng=rng))
    AHA = At.H * At
    for _ in range(20):
        v = AHA * v
        lmax = float(torch.linalg.vector_norm(v))
        v = v / lmax
    return 0.3 * lmax


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
@pytest.mark.parametrize("n", [32, 48])
def test_cg_history_matches_reference(n, builder):
    rng, Aj, _, At, _ = _problem(n)
    b = _rhs(Aj, n, rng)
    lam = _lamda(At, n, rng)
    xj, ij = jit_.cg(Aj.H * Aj, b, lamda=lam, tol=0.0, maxiter=10,
                     history=True)
    xt, it = cg(At.H * At, torch.from_numpy(b), lamda=lam, tol=0.0,
                maxiter=10, history=True)
    assert rel_err(xt, np.asarray(xj)) < 1e-4
    assert rel_err(it["resids"], np.asarray(ij["resids"])) < 1e-4
    assert int(it["iters"]) == int(ij["iters"]) == 10
    assert it["resids"].shape == (10,)


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
@pytest.mark.parametrize("history", [False, True])
def test_cg_tol_freeze_matches_reference(history, builder):
    """tol > 0: the solve freezes where the reference's loop stops; x,
    iters and the final residual agree."""
    rng, Aj, _, At, _ = _problem(32)
    b = _rhs(Aj, 32, rng)
    xj, ij = jit_.cg(Aj.H * Aj, b, lamda=0.1, tol=0.05, maxiter=10,
                     history=history)
    xt, it = cg(At.H * At, torch.from_numpy(b), lamda=0.1, tol=0.05,
                maxiter=10, history=history)
    assert int(it["iters"]) == int(ij["iters"]) < 10
    assert rel_err(xt, np.asarray(xj)) < 1e-4
    assert abs(float(it["resid"]) - float(ij["resid"])) <= \
        1e-4 * float(ij["resid"])
    assert float(it["resid"]) <= 0.05
    if history:
        assert rel_err(it["resids"], np.asarray(ij["resids"])) < 1e-4


def test_cg_takes_a_callable_and_numpy(rng):
    n = 24
    B = rand64c(n, n, rng=rng)
    H = (np.eye(n) + B.conj().T @ B / (4 * n)).astype(np.complex64)
    b = rand64c(n, rng=rng)
    Ht = torch.from_numpy(H)
    x, info = cg(lambda v: Ht @ v, b, tol=0.0, maxiter=40, device="cpu")
    ref = np.linalg.solve(H.astype(np.complex128), b.astype(np.complex128))
    assert rel_err(x, ref) < 1e-4
    assert "resids" not in info and int(info["iters"]) <= 40
    assert float(info["resid"]) < 1e-5


@pytest.mark.parametrize("n,oversamp", [(64, 1.5), (100, 2.0)])
def test_1d_nufft_op_matches_reference(n, oversamp, rng, builder):
    """1D: interp 'auto' resolves to the sparse leaf, as in the
    reference (Morton tiling of 128 grid nodes when the grid divides)."""
    traj = rng.random((300, 1)) - 0.5
    Aj, pj = jit_.models.nufft_op(traj, (n,), oversamp=oversamp)
    At, pt = nufft_op(traj, (n,), oversamp=oversamp, device="cpu")
    np.testing.assert_array_equal(pt.perm, pj.perm)
    assert len(_leaves(At, SpMatrix)) == 1
    x = rand64c(n, 2, rng=rng)
    y = rand64c(300, 2, rng=rng)
    assert rel_err(At * torch.from_numpy(x), np.asarray(Aj * x)) < 1e-5
    assert rel_err(At.H * torch.from_numpy(y), np.asarray(Aj.H * y)) < 1e-5
