"""The Cartesian SENSE model of the port: ``centered_fft_op`` and
``cartesian_sense_op`` against the reference (<= 1e-5, f32 operator level)
and against the port's own float64 ``oracle`` (<= 1e-5); the port's oracle
against the reference's (equal: it is a copy); and the <= 1e-6 f32-vs-float64
bar of tests/test_precision.py for a CG solve run to convergence.
"""
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import indigo_tpu_torch as tit
from indigo_tpu import oracle as joracle
from indigo_tpu.models import cartesian_sense_op as j_cartesian_sense_op
from indigo_tpu.models import centered_fft_op as j_centered_fft_op
from indigo_tpu_torch import oracle
from indigo_tpu_torch.convert import operator_from_reference
from indigo_tpu_torch.models import cartesian_sense_op, centered_fft_op
from indigo_tpu_torch.utils import rand64c, rel_err

TOL = 1e-5


@pytest.mark.parametrize("shape", [(12,), (8, 6), (4, 6, 8)])
def test_centered_fft_op(rng, shape):
    n = int(np.prod(shape))
    x = rand64c(n, 2, rng=rng)
    op, ref = centered_fft_op(shape, device="cpu"), j_centered_fft_op(shape)
    assert [type(c).__name__ for c in op.children()] == \
        [type(c).__name__ for c in ref.children()]
    assert rel_err(op * x, np.asarray(ref * x)) < TOL
    assert rel_err(op.H * x, np.asarray(ref.H * x)) < TOL
    want = oracle.centered_fft(x.reshape(shape + (2,)),
                               axes=tuple(range(len(shape))))
    assert rel_err(op * x, want.reshape(n, 2)) < TOL


def _problem(rng, shape, nc):
    mask = rng.random(shape) < 0.4
    mask[tuple(s // 2 for s in shape)] = True
    return mask, rand64c(nc, *shape, rng=rng)


@pytest.mark.parametrize("shape,nc", [((8, 8), 3), ((6, 10), 2),
                                      ((4, 6, 8), 2)])
def test_cartesian_sense_op(rng, shape, nc):
    mask, maps = _problem(rng, shape, nc)
    A = cartesian_sense_op(mask, maps, device="cpu")
    ref = j_cartesian_sense_op(mask, maps)
    assert A.shape == tuple(ref.shape)
    n = int(np.prod(shape))
    x = rand64c(n, 2, rng=rng)
    y = rand64c(A.shape[0], 2, rng=rng)
    assert rel_err(A * x, np.asarray(ref * x)) < TOL
    assert rel_err(A.H * y, np.asarray(ref.H * y)) < TOL
    assert rel_err(A * x, oracle.cartesian_sense_forward(x, mask, maps)) < TOL
    assert rel_err(A.H * y,
                   oracle.cartesian_sense_adjoint(y, mask, maps)) < TOL
    # the converted reference tree is the same operator
    conv = operator_from_reference(ref, device="cpu")
    assert rel_err(conv * x, A * x) < 1e-6


def test_oracle_is_a_copy_of_the_reference_oracle(rng):
    assert sorted(oracle.__all__) == sorted(joracle.__all__)
    shape, nc = (6, 8), 2
    mask, maps = _problem(rng, shape, nc)
    x = rand64c(48, 2, rng=rng)
    y = oracle.cartesian_sense_forward(x, mask, maps)
    np.testing.assert_array_equal(
        y, joracle.cartesian_sense_forward(x, mask, maps))
    np.testing.assert_array_equal(
        oracle.cartesian_sense_adjoint(y, mask, maps),
        joracle.cartesian_sense_adjoint(y, mask, maps))
    traj = rng.random((20, 2)) - 0.5
    np.testing.assert_array_equal(
        oracle.nufft_forward(x[:, 0], traj, shape),
        joracle.nufft_forward(x[:, 0], traj, shape))
    np.testing.assert_array_equal(
        oracle.nufft_adjoint(y[:20], traj, shape),
        joracle.nufft_adjoint(y[:20], traj, shape))
    np.testing.assert_array_equal(
        oracle.sense_nufft_forward(x[:, 0], traj, maps),
        joracle.sense_nufft_forward(x[:, 0], traj, maps))
    np.testing.assert_array_equal(
        oracle.dwt(x, (6, 8), "haar", 1), joracle.dwt(x, (6, 8), "haar", 1))
    np.testing.assert_array_equal(oracle.soft_thresh(x, 0.5),
                                  joracle.soft_thresh(x, 0.5))
    M = rand64c(48, 48, rng=rng)
    H = M.conj().T @ M + 48 * np.eye(48)
    a, _ = oracle.cg(lambda v: H @ v, x[:, 0], maxiter=20)
    b, _ = joracle.cg(lambda v: H @ v, x[:, 0], maxiter=20)
    np.testing.assert_array_equal(a, b)
    g = lambda v: H @ v - x[:, 0]  # noqa: E731
    p = lambda v, s: oracle.soft_thresh(v, 0.1 * s)  # noqa: E731
    np.testing.assert_array_equal(
        oracle.fista(g, p, 1e-3, np.zeros(48, complex), maxiter=5),
        joracle.fista(g, p, 1e-3, np.zeros(48, complex), maxiter=5))


def test_north_star_cartesian_cg_1e6():
    """f32 CG to convergence on the optimized normal operator vs the
    float64 solution of the oracle's normal equations: <= 1e-6."""
    rng = np.random.default_rng(2)
    n = 64
    mask = np.zeros((n, n), bool)
    mask[rng.random((n, n)) < 0.5] = True
    mask[n // 2 - 4:n // 2 + 4] = True
    maps = np.asarray(rand64c(4, n, n, rng=rng), np.complex64)
    x_true = rand64c(n * n, 1, rng=rng).astype(np.complex64)
    A = cartesian_sense_op(mask, maps, device="cpu")
    y = A * x_true
    AHy = A.H * y
    lam = 1e-2
    maps64 = maps.astype(np.complex128)

    def mv(v):
        v = v.astype(np.complex128)
        z = oracle.cartesian_sense_adjoint(
            oracle.cartesian_sense_forward(v[:, None], mask, maps64),
            mask, maps64)[:, 0]
        return z + lam * v

    lin = spla.LinearOperator((n * n, n * n), matvec=mv,
                              dtype=np.complex128)
    x64, info = spla.cg(lin, AHy[:, 0].numpy().astype(np.complex128),
                        rtol=1e-14, maxiter=5000)
    assert info == 0
    x32, _ = tit.cg((A.H * A).optimize(), AHy, lamda=lam, tol=0.0,
                    maxiter=100)
    err = rel_err(x32[:, 0], x64)
    assert err <= 1e-6, f"north-star miss: {err:.2e}"


def test_example_recipe_against_the_reference(rng):
    """The config-1 recipe as the example writes it (SpMatrix(P) *
    UnscaledFFT * Diag, optimize, cg on the optimized normal operator) at
    32^2: the port against the reference, <= 1e-4 on the image."""
    import scipy.sparse as sp
    import indigo_tpu as jit_

    n = 32
    keep = np.zeros(n, bool)
    keep[::2] = True
    keep[n // 2 - n // 8:n // 2 + n // 8] = True
    rows = np.flatnonzero(np.repeat(keep, n))
    P = sp.csr_matrix((np.ones(len(rows), np.float32),
                       (np.arange(len(rows)), rows)),
                      shape=(len(rows), n * n))
    yy, xx = np.mgrid[0:n, 0:n] / n
    d = (0.5 + np.exp(-((xx - 0.5) ** 2 + (yy - 0.5) ** 2) * 4)).astype(
        np.complex64).ravel()
    x_true = rand64c(n * n, rng=rng)
    out = {}
    for key, pkg, kw in (("ref", jit_, {}), ("port", tit, {"device": "cpu"})):
        A = (pkg.SpMatrix(P, **kw) * pkg.UnscaledFFT((n, n), **kw)
             * pkg.Diag(d, **kw))
        A = A.optimize()
        y = A * x_true
        AHA = (A.H * A).optimize()
        x, info = pkg.cg(AHA, A.H * y, lamda=1.0, tol=1e-8, maxiter=60)
        out[key] = (np.asarray(x), int(info["iters"]), AHA)
    assert out["port"][1] == out["ref"][1]
    assert rel_err(out["port"][0], out["ref"][0]) < 1e-4
    kinds = {type(m).__name__ for m in out["port"][2].modules()}
    assert "SpMatrix" not in kinds      # P^H P fused into a Diag


def test_example_recipe_at_its_own_lamda_differs_only_in_the_null_space():
    """The example's recipe at 128^2 with its own lamda 1e-6, through the
    functions ``chip_smoke.py`` runs on the card: the port and the reference
    both meet the example's data-consistency bar, their images differ by
    O(1) because the singular system leaves the null-space part to
    rounding, and the part the data determine (the projection onto
    range(A^H), in float64) agrees with the float64 minimum-norm solution
    within the bar ``range_part`` states (1e-4, or twice the f32 storage
    rounding of an image whose null-space part dominates). Run with ``-s``
    to read the numbers."""
    import os
    import sys
    import indigo_tpu as jit_
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    n = 128
    P, d, x_true = cs.cartesian_example_problem(n)
    lam = 1e-2 * n * n * float(np.abs(d).max()) ** 2
    A64, pinv = cs.example_float64(P, d, n)
    y64 = A64(x_true.astype(np.complex128))
    x_mn = pinv(y64)
    assert rel_err(A64(x_mn), y64) < 1e-12
    img, posed, read = {}, {}, {}
    for key, pkg, kw in (("port", tit, {"device": "cpu"}),
                         ("reference", jit_, {})):
        img[key], posed[key], iters, _ = cs.cartesian_example_solve(
            pkg, P, d, x_true, n, lam, **kw)
        r = read[key] = cs.range_part(img[key], y64, x_mn, A64, pinv)
        print(f"{key}: iters={iters} data_consistency={r['dc']:.3e} "
              f"norm_over_range_part={r['ratio']:.1f} "
              f"range_part_vs_float64={r['err']:.3e} bar={r['bar']:.3e}")
        assert r["dc"] < 1e-3
        assert r["err"] <= r["bar"]
    raw = rel_err(img["port"], img["reference"])
    rng_err = rel_err(read["port"]["px"], read["reference"]["px"])
    well = rel_err(posed["port"], posed["reference"])
    print(f"port vs reference: images={raw:.3e} range_parts={rng_err:.3e} "
          f"images_at_lamda_{lam:.4g}={well:.3e}")
    assert rng_err <= read["port"]["bar"] + read["reference"]["bar"]
    assert well <= 1e-4


def test_cartesian_on_tensor_inputs_and_devices(rng):
    """Tensors and numpy arrays are the same operand; the tree moves as one
    module."""
    mask, maps = _problem(rng, (8, 8), 2)
    A = cartesian_sense_op(mask, maps, device="cpu")
    x = rand64c(64, 1, rng=rng)
    assert torch.equal(A * x, A * torch.from_numpy(x))
    assert A.device == torch.device("cpu")
    assert A.to("cpu").device == torch.device("cpu")
