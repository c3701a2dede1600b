"""FISTA and its helpers: ``soft_thresh`` (1e-6), ``max_eigen`` (within 1e-2
of the true eigenvalue, as tests/test_solvers.py, and of the reference's
estimate), ``apgd`` with and without ``tol`` / ``history`` / ``objective``
against the reference on a well-conditioned lasso (<= 1e-5), and the
l1-wavelet compressed-sensing recipe of examples/cs_wavelet_fista.py at 32^2
against the reference (<= 1e-4) and the float64 oracle.
"""
import numpy as np
import pytest
import torch

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu_torch import oracle
from indigo_tpu_torch.utils import rand64c, rel_err


def test_soft_thresh(rng):
    x = np.asarray([3.0 + 4.0j, 0.1, -2.0, 0.0], dtype=np.complex64)
    y = tit.soft_thresh(torch.from_numpy(x), 1.0).numpy()
    assert abs(y[0] - (3 + 4j) * (4 / 5)) < 1e-6
    assert y[1] == 0 and y[3] == 0
    assert abs(y[2] - (-1.0)) < 1e-6
    v = rand64c(50, 3, rng=rng)
    out = tit.soft_thresh(torch.from_numpy(v), 0.7)
    assert out.dtype == torch.complex64
    assert rel_err(out, np.asarray(jit_.soft_thresh(v, 0.7))) < 1e-6
    assert rel_err(out, oracle.soft_thresh(v, 0.7)) < 1e-6
    r = torch.tensor([2.0, -0.5, -3.0])
    assert torch.allclose(tit.soft_thresh(r, 1.0),
                          torch.tensor([1.0, 0.0, -2.0]))


def _spd(n, rng):
    M = rand64c(n, n, rng=rng)
    return (M.conj().T @ M + n * np.eye(n)).astype(np.complex64)


def test_max_eigen(rng):
    A = _spd(20, rng)
    want = float(np.linalg.eigvalsh(A).max())
    lam = tit.max_eigen(tit.DenseMatrix(A, device="cpu"), 20, iters=200)
    assert lam.dim() == 0 and not lam.is_complex()
    assert abs(float(lam) - want) / want < 1e-2
    ref = float(jit_.max_eigen(jit_.DenseMatrix(A), 20, iters=200).real)
    assert abs(float(lam) - ref) / ref < 1e-2
    # a callable, an int seed and a generator are the same contract
    At = torch.from_numpy(A)
    a = tit.max_eigen(lambda v: At @ v, 20, iters=200, key=3, device="cpu")
    g = torch.Generator().manual_seed(3)
    b = tit.max_eigen(lambda v: At @ v, 20, iters=200, key=g, device="cpu")
    assert float(a) == float(b)
    assert abs(float(a) - want) / want < 1e-2
    # float(x.real), as the example reads it
    assert float(lam.real) == float(lam)


def _lasso(rng):
    m, n = 60, 24
    A = (rand64c(m, n, rng=rng) / np.sqrt(m)).astype(np.complex64)
    x_true = np.zeros(n, np.complex64)
    x_true[:5] = rand64c(5, rng=rng)
    b = (A @ x_true).astype(np.complex64)
    L = float(np.linalg.norm(A, 2)) ** 2
    return A, b, L, n


def _both(rng, lam=0.02, **kw):
    """The same lasso through both packages; returns (port, reference)."""
    import jax.numpy as jnp
    A, b, L, n = _lasso(rng)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    has_obj = kw.pop("objective", False)
    pk, jk = dict(kw), dict(kw)
    if has_obj:
        pk["objective"] = lambda x: (
            0.5 * torch.linalg.vector_norm(At @ x - bt) ** 2
            + lam * x.abs().sum())
        jk["objective"] = lambda x: (
            0.5 * jnp.linalg.norm(Aj @ x - bj) ** 2
            + lam * jnp.abs(x).sum())
    xp, ip = tit.apgd(lambda x: At.conj().T @ (At @ x - bt),
                      lambda v, s: tit.soft_thresh(v, lam * s), 1.0 / L,
                      torch.zeros(n, dtype=torch.complex64), **pk)
    xj, ij = jit_.apgd(lambda x: Aj.conj().T @ (Aj @ x - bj),
                       lambda v, s: jit_.soft_thresh(v, lam * s), 1.0 / L,
                       jnp.zeros(n, jnp.complex64), **jk)
    return (xp, ip), (xj, ij)


@pytest.mark.parametrize("kw", [
    dict(maxiter=60),
    dict(maxiter=60, history=True),
    dict(maxiter=60, history=True, objective=True),
    dict(maxiter=300, tol=1e-5),
    dict(maxiter=300, tol=1e-5, history=True, objective=True),
], ids=["plain", "history", "objective", "tol", "tol_history_objective"])
def test_apgd_matches_reference(rng, kw):
    (xp, ip), (xj, ij) = _both(rng, **kw)
    assert rel_err(xp, np.asarray(xj)) < 1e-5
    assert ip["iters"].dim() == 0 and ip["iters"].dtype == torch.int32
    assert int(ip["iters"]) == int(ij["iters"])
    assert sorted(ip) == sorted(ij)
    if kw.get("tol"):
        assert int(ip["iters"]) < kw["maxiter"]
    else:
        assert int(ip["iters"]) == kw["maxiter"]
    if "deltas" in ip:
        d, dj = ip["deltas"].numpy(), np.asarray(ij["deltas"])
        assert d.shape == dj.shape == (kw["maxiter"],)
        assert rel_err(d, dj) < 1e-4
        k = int(ip["iters"])
        assert (d[k:] == 0).all()
    if "objs" in ip:
        o, oj = ip["objs"].numpy(), np.asarray(ij["objs"])
        assert rel_err(o, oj) < 1e-5
        assert o[-1] <= o[0]


def test_apgd_vs_oracle_and_aliases(rng):
    assert tit.fista is tit.apgd
    A, b, L, n = _lasso(rng)
    lam = 0.02
    A64, b64 = A.astype(np.complex128), b.astype(np.complex128)
    want = oracle.fista(lambda x: A64.conj().T @ (A64 @ x - b64),
                        lambda v, s: oracle.soft_thresh(v, lam * s),
                        1.0 / L, np.zeros(n, np.complex128), maxiter=80)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x, info = tit.apgd(lambda x: At.conj().T @ (At @ x - bt),
                       lambda v, s: tit.soft_thresh(v, lam * s), 1.0 / L,
                       np.zeros(n, np.complex64), maxiter=80, device="cpu")
    assert rel_err(x, want) < 1e-5
    assert sorted(info) == ["iters"]
    x0, info0 = tit.apgd(lambda x: x, lambda v, s: v, 1.0,
                         torch.ones(3), maxiter=0, history=True)
    assert int(info0["iters"]) == 0 and info0["deltas"].shape == (0,)


def _vardens_mask(shape, accel, center, rng):
    ny, _ = shape
    p = 1.0 / (1.0 + 40.0 * np.abs(np.linspace(-0.5, 0.5, ny)))
    p = p / p.mean() / accel
    rows = rng.random(ny) < p
    rows[int(ny * (0.5 - center / 2)):int(ny * (0.5 + center / 2))] = True
    mask = np.zeros(shape, bool)
    mask[rows] = True
    return mask


def test_cs_wavelet_recipe_matches_reference():
    """The example's recipe at 32^2 / 4 coils, 40 iterations: the same
    data, step and threshold through both packages; image <= 1e-4."""
    import jax.numpy as jnp
    from indigo_tpu.models import cartesian_sense_op as j_cart
    from indigo_tpu_torch.models import cartesian_sense_op

    rng = np.random.default_rng(0)
    n, nc, lam, iters = 32, 4, 2e-3, 40
    yy, xx = np.mgrid[0:n, 0:n] / n
    maps = np.asarray([
        (0.5 + np.exp(-(((xx - a) ** 2 + (yy - b) ** 2) * 3)))
        * np.exp(1j * 2 * np.pi * (a * xx + b * yy))
        for a, b in [(0.3, 0.3), (0.3, 0.7), (0.7, 0.3), (0.7, 0.7)]],
        dtype=np.complex64)
    mask = _vardens_mask((n, n), 3, 0.08, rng)
    img = np.zeros((n, n), np.complex64)
    img[((xx - .5) / .35) ** 2 + ((yy - .5) / .45) ** 2 <= 1] += 1.0
    img[((xx - .45) / .1) ** 2 + ((yy - .5) / .15) ** 2 <= 1] -= 0.5
    x_true = img.ravel()

    A, Aj = cartesian_sense_op(mask, maps, device="cpu"), j_cart(mask, maps)
    W = tit.DWT((n, n), wavelet="db4", levels=2, device="cpu")
    Wj = jit_.DWT((n, n), wavelet="db4", levels=2)
    y = np.asarray(Aj * x_true[:, None])
    y = y + 0.01 * np.abs(y).mean() * rand64c(*y.shape, rng=rng)
    Lp = float(tit.max_eigen(A.H * A, n * n, iters=30))
    Lj = float(jit_.max_eigen(Aj.H * Aj, n * n, iters=30).real)
    assert abs(Lp - Lj) / Lj < 1e-2
    L = 1.05 * Lj                       # one step size for both
    yt = torch.from_numpy(y)

    def gradf(u):
        r = A.apply(W.apply(u, adjoint=True)) - yt
        return W.apply(A.apply(r, adjoint=True))

    def gradf_j(u):
        r = Aj.apply(Wj.apply(u, adjoint=True)) - jnp.asarray(y)
        return Wj.apply(Aj.apply(r, adjoint=True))

    u0 = np.zeros((n * n, 1), np.complex64)
    up, _ = tit.apgd(gradf, lambda v, a: tit.soft_thresh(v, lam * a),
                     1.0 / L, u0, maxiter=iters, device="cpu")
    uj, _ = jit_.apgd(gradf_j, lambda v, a: jit_.soft_thresh(v, lam * a),
                      1.0 / L, u0, maxiter=iters)
    assert rel_err(up, np.asarray(uj)) < 1e-4
    xp = (W.H * up)[:, 0]
    assert rel_err(xp, np.asarray(Wj.H * np.asarray(uj))[:, 0]) < 1e-4
    # and it reconstructs: closer to the phantom than the zero-filled image
    x_zf = (A.H * yt)[:, 0].numpy() / nc
    zf = rel_err(x_zf / abs(x_zf).max() * abs(x_true).max(), x_true)
    assert rel_err(xp, x_true) < zf
