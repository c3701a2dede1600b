"""batched_cg: the port vs the reference on one random SPD matvec, with
the tol freeze, a Jacobi preconditioner and iteration counts. Tolerance
1e-5 (f32; reductions sum in another order). solvers.cg against
batched_cg: the one loop both run."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indigo_tpu.parallel.recon import batched_cg as j_cg
from indigo_tpu_torch.parallel.recon import batched_cg
from indigo_tpu_torch.utils import rand64c, rel_err


def _problem(rng, n=40, S=3):
    B = rand64c(n, n, rng=rng)
    H = (np.eye(n) + B.conj().T @ B / (4 * n)).astype(np.complex64)
    rhs = rand64c(S, n, rng=rng)
    # slice 2 is an eigenvector: CG solves it in one step, so under tol it
    # freezes while the others still run
    rhs[2] = np.linalg.eigh(H.astype(np.complex128))[1][:, 0]
    pd = (1.0 / np.real(np.diag(H))).astype(np.float32)
    return H, rhs, pd


@pytest.mark.parametrize("tol,use_pd", [(0.0, False), (1e-3, False),
                                        (1e-3, True)])
def test_batched_cg_matches_reference(rng, tol, use_pd):
    H, rhs, pd = _problem(rng)
    Hj, Ht = jnp.asarray(H), torch.from_numpy(H)
    pdj, pdt = jnp.asarray(pd), torch.from_numpy(pd)
    xj, rj, kj = j_cg(lambda v: v @ Hj.T, jnp.asarray(rhs), lamda=0.05,
                      iters=12, tol=tol, return_iters=True,
                      precond=(lambda r: r * pdj[None]) if use_pd else None)
    xt, rt, kt = batched_cg(lambda v: v @ Ht.T, torch.from_numpy(rhs),
                            lamda=0.05, iters=12, tol=tol, return_iters=True,
                            precond=(lambda r: r * pdt[None]) if use_pd
                            else None)
    assert rel_err(xt, np.asarray(xj)) < 1e-5
    assert rel_err(rt, np.asarray(rj)) < 1e-5
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    if tol > 0:
        assert int(kt.min()) < int(kt.max()) < 12


def test_batched_cg_solves(rng):
    H, rhs, _ = _problem(rng, n=20, S=3)
    x, resids = batched_cg(lambda v: v @ torch.from_numpy(H).T,
                           torch.from_numpy(rhs), lamda=0.0, iters=60)
    ref = np.linalg.solve(H.astype(np.complex128), rhs.T.astype(
        np.complex128)).T
    assert rel_err(x, ref) < 1e-4
    assert resids.shape == (60, 3)


@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("use_pd", [False, True])
def test_cg_and_batched_cg_run_one_loop(rng, tol, use_pd):
    """solvers.cg on one vector and batched_cg on one row take the same
    steps: the same iterates, counts and (relative x ||b||) residuals."""
    from indigo_tpu_torch.solvers import cg
    H, rhs, pd = _problem(rng)
    Ht, b, pdt = (torch.from_numpy(a) for a in (H, rhs[0], pd))
    x, info = cg(lambda v: Ht @ v, b, lamda=0.05, tol=tol, maxiter=12,
                 history=True, precond=(lambda r: r * pdt) if use_pd
                 else None)
    xs, resids, k = batched_cg(lambda v: v @ Ht.T, b[None], lamda=0.05,
                               iters=12, tol=tol, return_iters=True,
                               precond=(lambda r: r * pdt[None]) if use_pd
                               else None)
    assert rel_err(x, xs[0].numpy()) < 1e-6
    assert int(info["iters"]) == int(k[0])
    assert int(k[0]) == 12 if tol == 0 else int(k[0]) < 12
    bnorm = torch.linalg.vector_norm(b)
    assert rel_err(info["resids"] * bnorm, resids[:, 0].numpy()) < 1e-6


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_cg_of_zero_takes_no_step(tol):
    from indigo_tpu_torch.solvers import cg
    H = torch.eye(8, dtype=torch.complex64) * 2
    x, info = cg(lambda v: H @ v, torch.zeros(8, dtype=torch.complex64),
                 tol=tol, maxiter=5, history=True)
    assert int(info["iters"]) == 0
    assert not x.any()
    assert float(info["resid"]) == 0.0
