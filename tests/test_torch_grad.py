"""Gradients through the port against the reference's reverse mode.

The same inputs go through the port under torch autograd and through the
reference under ``jax.grad``. Convention: for a real loss
L = Re sum(conj(c) * f(x)), torch's ``x.grad`` after ``L.backward()`` is
conj(jax.grad(L)(x)); for a linear f that is conj(vjp(conj(c))), the
reference's vjp on the conjugated cotangent, conjugated.

The reference's Pallas kernels have no reverse mode, so where the port's
operand runs a kernel (K1-K4, here their plain versions on the CPU) the
reference runs its jnp form of the same operator: "block" for the kernel
layout, the "dft" method for ToeplitzNormal's "pallas". The autograd
Functions that carry the kernels on the card (``ops.dft_cuda.
_SenseNormalFn``, ``ops.ell_spmm._SpmmFn``) run here with their plain
launches, against autograd through the plain version with no Function.

Tolerances: 1e-5 for operators (f32 sums in another order), 1e-4 for
solves (rounding grows over the CG iterations), 1e-6 for a Function
against autograd through the same plain version.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import indigo_tpu as jit_
from indigo_tpu.models import SenseRecon as JRecon
from indigo_tpu.models import nufft_op as j_nufft_op
from indigo_tpu.ops.dft_fft import block_spectrum
from indigo_tpu.ops.dft_pallas import from_sigma_basis as j_from_sigma
from indigo_tpu.ops.dft_pallas import to_sigma_basis as j_to_sigma
from indigo_tpu.parallel.recon import batched_cg as j_batched_cg
from indigo_tpu.parallel.recon import sense_normal_batched as j_batched
from indigo_tpu.toeplitz import ToeplitzNormal as JToeplitz
from indigo_tpu.utils import randM
import indigo_tpu_torch as tit
from indigo_tpu_torch.convert import operator_from_reference
from indigo_tpu_torch.models import SenseRecon, nufft_op
from indigo_tpu_torch.ops import _refuse_operator_grad
from indigo_tpu_torch.ops.dft_cuda import (
    _SenseNormalFn, solver_sigma_axes, sense_normal_reference,
    toeplitz_apply_reference)
from indigo_tpu_torch.ops.ell_spmm import (
    _SpmmFn, ell_spmm_cuda, jag_spmm_cuda, kernel_spmm)
from indigo_tpu_torch.parallel.recon import (
    batched_cg, sense_batch_recon, sense_normal_batched)
from indigo_tpu_torch.sparse import (
    bell_spmm, csr_to_bell, csr_to_jag, jag_spmm)
from indigo_tpu_torch.toeplitz import ToeplitzNormal, sense_normal_toeplitz
from indigo_tpu_torch.utils import rand64c, rel_err

from test_torch_native import BUILDERS, builder  # noqa: F401
from test_torch_operators import KINDS, _leaf

OP_TOL = 1e-5
SOLVE_TOL = 1e-4
FN_TOL = 1e-6


def _grads(f_port, f_ref, x, c, argnum=0):
    """(port grad, reference grad) of L = Re sum(conj(c) f(x)) in x, or in
    x[argnum] for a tuple x; the reference's grad conjugated."""
    xs = x if isinstance(x, tuple) else (x,)
    leaves = [torch.from_numpy(np.array(a)) for a in xs]
    leaves[argnum].requires_grad_()
    ct = torch.from_numpy(np.array(c))
    (ct.conj() * f_port(*leaves)).real.sum().backward()

    def loss(*a):
        return jnp.real(jnp.sum(jnp.conj(jnp.asarray(c)) * f_ref(*a)))

    g = jax.jit(jax.grad(loss, argnums=argnum))(*map(jnp.asarray, xs))
    return leaves[argnum].grad, np.conj(np.asarray(g))


@pytest.mark.parametrize("adjoint", [False, True], ids=["A", "AH"])
@pytest.mark.parametrize("kind", KINDS)
def test_operator_gradient_matches_reference(rng, kind, adjoint):
    ref = _leaf(kind, rng)
    op = operator_from_reference(ref, device="cpu")
    M, N = ref.shape
    n_in, n_out = (M, N) if adjoint else (N, M)
    x, c = rand64c(n_in, 3, rng=rng), rand64c(n_out, 3, rng=rng)
    g, g_ref = _grads(lambda v: op.apply(v, adjoint=adjoint),
                      lambda v: ref.apply(v, adjoint=adjoint), x, c)
    assert g.dtype == torch.complex64
    assert rel_err(g, g_ref) < OP_TOL


@pytest.mark.parametrize("method", ["pallas", "dft", "fft"])
def test_toeplitz_normal_gradient_matches_reference(rng, method):
    img = (8, 8, 16)
    Tf = rng.standard_normal(tuple(2 * s for s in img)).astype(np.float32)
    K = ToeplitzNormal(Tf, img, method=method, device="cpu")
    J = JToeplitz(Tf, img, method="fft" if method == "fft" else "dft")
    x, c = rand64c(512 * 2, 2, rng=rng), rand64c(512 * 2, 2, rng=rng)
    g, g_ref = _grads(K.apply, J.apply, x, c)
    assert rel_err(g, g_ref) < OP_TOL


@pytest.mark.parametrize("adjoint", [False, True], ids=["A", "AH"])
@pytest.mark.parametrize("img", [(16, 16), (8, 8, 8)])
def test_nufft_op_gradient_matches_reference(rng, img, adjoint):
    traj = rng.uniform(-0.5, 0.5, size=(200, len(img)))
    A, _ = nufft_op(traj, img, oversamp=2.0, device="cpu")
    ref, _ = j_nufft_op(traj, img, oversamp=2.0)
    assert "GridDFT" in [type(m).__name__ for m in A.modules()]
    n = int(np.prod(img))
    n_in, n_out = (200, n) if adjoint else (n, 200)
    x, c = rand64c(n_in, 2, rng=rng), rand64c(n_out, 2, rng=rng)
    g, g_ref = _grads(lambda v: A.apply(v, adjoint=adjoint),
                      lambda v: ref.apply(v, adjoint=adjoint), x, c)
    assert rel_err(g, g_ref) < OP_TOL


@pytest.mark.parametrize("adjoint", [False, True], ids=["A", "AH"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("fmt", ["jag", "bell", "element"])
def test_spmatrix_gradient_matches_reference(rng, fmt, dtype, adjoint):
    A = randM(120, 333, 0.03, rng=rng, dtype=dtype)
    top = tit.SpMatrix(A, format=fmt, device="cpu")
    jop = jit_.SpMatrix(A, format=fmt)
    n_in, n_out = (120, 333) if adjoint else (333, 120)
    x, c = rand64c(n_in, 3, rng=rng), rand64c(n_out, 3, rng=rng)
    g, g_ref = _grads(lambda v: top.apply(v, adjoint=adjoint),
                      lambda v: jop.apply(v, adjoint=adjoint), x, c)
    assert g.dtype == torch.complex64
    assert rel_err(g, g_ref) < OP_TOL


def _batched_inputs(rng, img, S=2, nc=4):
    Tf = rng.standard_normal(tuple(2 * s for s in img)).astype(np.float32)
    n = int(np.prod(img))
    return (Tf, rand64c(nc, *img, rng=rng), rand64c(S, n, rng=rng),
            rand64c(S, n, rng=rng))


@pytest.mark.parametrize("coil_chunk", [None, 2])
@pytest.mark.parametrize("layout", ["raw", "block", "kernel", "fft"])
def test_sense_normal_batched_gradient_matches_reference(rng, layout,
                                                         coil_chunk):
    Tf, maps, xs, c = _batched_inputs(rng, (8, 8, 16))
    Tp = block_spectrum(Tf) if layout in ("block", "kernel") else Tf
    Tj = Tf if layout in ("raw", "fft") else Tp

    def port(v):
        return sense_normal_batched(torch.from_numpy(Tp),
                                    torch.from_numpy(maps), v,
                                    coil_chunk=coil_chunk, layout=layout)

    def ref(v):
        return j_batched(Tj, maps, v, coil_chunk=coil_chunk,
                         layout="block" if layout == "kernel" else layout)

    g, g_ref = _grads(port, ref, xs, c)
    assert rel_err(g, g_ref) < OP_TOL


def test_sense_normal_batched_sigma_gradient_matches_reference(rng):
    """sigma=True on an axis longer than 128: the operand and the result
    in the sigma basis; the reference's kernel layout has no reverse mode,
    so it runs its sigma helpers around its block layout."""
    img = (8, 136, 8)
    Tf, maps, xs, c = _batched_inputs(rng, img, S=1, nc=2)
    Tb = block_spectrum(Tf)
    ax = solver_sigma_axes(img)
    assert ax == (2,)

    def port(v):
        return sense_normal_batched(torch.from_numpy(Tb),
                                    torch.from_numpy(maps), v,
                                    layout="kernel", sigma=True)

    def ref(v):
        u = j_from_sigma(v.reshape((1,) + img), ax).reshape(1, -1)
        u = j_batched(Tb, maps, u, layout="block")
        return j_to_sigma(u.reshape((1,) + img), ax).reshape(1, -1)

    g, g_ref = _grads(port, ref, xs, c)
    assert rel_err(g, g_ref) < OP_TOL


def test_maps_gradient_on_cpu_matches_reference(rng):
    """The operator's own tensors differentiate on the CPU as before: the
    maps of sense_normal_batched and of the Toeplitz tree."""
    img = (8, 8, 8)
    Tf, maps, xs, c = _batched_inputs(rng, img, S=2, nc=3)
    Tb = block_spectrum(Tf)
    g, g_ref = _grads(
        lambda m, v: sense_normal_batched(torch.from_numpy(Tb), m, v,
                                          layout="kernel"),
        lambda m, v: j_batched(Tb, m, v, layout="block"), (maps, xs), c)
    assert rel_err(g, g_ref) < OP_TOL
    # the tree holds its maps as numpy in the reference: its operator is
    # differentiated there through sense_normal_batched on the raw spectrum
    x = torch.from_numpy(np.ascontiguousarray(xs.T))
    g, g_ref = _grads(
        lambda m: sense_normal_toeplitz(Tf, m, device="cpu").apply(x).T,
        lambda m: j_batched(Tf, m, xs), maps, c)
    assert rel_err(g, g_ref) < OP_TOL


def _solve_problem(rng):
    from indigo_tpu.toeplitz import toeplitz_kernel as j_toeplitz_kernel

    img, nc = (8, 8, 16), 3
    traj = rng.random((300, 3)) - 0.5
    Tf = np.asarray(j_toeplitz_kernel(traj, img, oversamp=2.0, width=4))
    lam = 0.05 * float(np.abs(Tf).max())
    n = int(np.prod(img))
    return (Tf, rand64c(nc, *img, rng=rng), rand64c(2, n, rng=rng), lam,
            rand64c(2, n, rng=rng))


def test_batched_cg_gradient_matches_reference(rng):
    Tf, maps, rhs, lam, c = _solve_problem(rng)
    Tb = block_spectrum(Tf)
    m = torch.from_numpy(maps)

    def port(r):
        return batched_cg(
            lambda v: sense_normal_batched(torch.from_numpy(Tb), m, v,
                                           layout="kernel", coil_chunk=1),
            r, lamda=lam, iters=10)[0]

    def ref(r):
        return j_batched_cg(
            lambda v: j_batched(Tb, maps, v, layout="block", coil_chunk=1),
            r, lamda=lam, iters=10)[0]

    g, g_ref = _grads(port, ref, rhs, c)
    assert torch.isfinite(g).all()
    assert rel_err(g, g_ref) < SOLVE_TOL


def test_sense_batch_recon_gradient_matches_reference(rng):
    Tf, maps, rhs, lam, c = _solve_problem(rng)

    def port(r):
        return sense_batch_recon(torch.from_numpy(Tf),
                                 torch.from_numpy(maps), r, lamda=lam,
                                 iters=10, coil_chunk=1)[0]

    def ref(r):
        return j_batched_cg(
            lambda v: j_batched(Tf, maps, v, coil_chunk=1),
            r, lamda=lam, iters=10)[0]

    g, g_ref = _grads(port, ref, rhs, c)
    assert rel_err(g, g_ref) < SOLVE_TOL


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
def test_sense_recon_gradient_matches_reference(rng, builder):
    """SenseRecon at 16^3: k-space (user order) -> rhs -> solve, against
    the reference's own rhs and CG bodies (its cjit boundary is host
    numpy, so the same jnp functions are composed here), with both
    packages gridding on each builder (tests/test_torch_native.py)."""
    from test_torch_recon import CONFIGS, smooth_maps

    cfg = CONFIGS["3d"]
    traj = cfg["traj"]()
    maps = smooth_maps(cfg["img"], cfg["centers"])
    kw = cfg["kw"]
    j = JRecon(traj, maps, **kw)
    p = SenseRecon(traj, maps, device="cpu", **kw)
    assert p.layout == "block"
    n = int(np.prod(cfg["img"]))
    perm = p.perm.numpy()
    jm = jnp.asarray(maps)
    y = rand64c(p.nc * p.n_samples, rng=rng)
    c = rand64c(n, rng=rng)

    def port(yy):
        return p.solve(p.rhs(yy))[0]

    def ref(yy):
        ys = yy.reshape(p.nc, -1)[:, perm].reshape(-1, 1)
        r = j.A.apply(j._wd[:, None] * ys, adjoint=True).reshape(1, n)
        return j_batched_cg(
            lambda v: j_batched(j._Tf, jm, v, layout="block"),
            r, lamda=j.lamda, iters=j.iters)[0][0]

    g, g_ref = _grads(port, ref, y, c)
    assert g.shape == (p.nc * p.n_samples,)
    assert rel_err(g, g_ref) < SOLVE_TOL


# --- the Functions, with their plain launches ---------------------------


def _plain_launch(Tf, v, maps, events):
    """The plain version in the launch signature of ``dft_cuda._run``."""
    if maps is None:
        return toeplitz_apply_reference(Tf, v)
    return sense_normal_reference(Tf, maps, v)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_toeplitz_function_backward_matches_plain_autograd(rng, kernel):
    img = (8, 8, 16)
    Tf, maps, xs, _ = _batched_inputs(rng, img, S=2, nc=3)
    T = torch.from_numpy(block_spectrum(Tf))
    m = None if kernel == "K2" else torch.from_numpy(maps)
    v = torch.from_numpy(xs.reshape((2,) + img))
    g = torch.from_numpy(rand64c(2, *img, rng=rng))
    calls = []

    def launch(*a):
        calls.append(a[1])
        return _plain_launch(*a)

    vf = v.clone().requires_grad_()
    out = _SenseNormalFn.apply(launch, T, m, vf)
    out.backward(g)
    assert len(calls) == 2 and calls[1] is not vf      # one backward launch
    vp = v.clone().requires_grad_()
    _plain_launch(T, vp, m, None).backward(g)
    assert rel_err(vf.grad, vp.grad) < FN_TOL
    # Hermitian: the backward is exactly one more forward on the cotangent
    np.testing.assert_array_equal(vf.grad.numpy(),
                                  _plain_launch(T, g, m, None).numpy())


@pytest.mark.parametrize("complex_x", [False, True])
@pytest.mark.parametrize("fmt", ["jag", "bell"])
def test_spmm_function_backward_matches_plain_autograd(rng, fmt, complex_x):
    A = sp.csr_matrix(randM(90, 200, 0.05, rng=rng, dtype=np.float32))
    conv, kernel, plain = ((csr_to_jag, jag_spmm_cuda, jag_spmm)
                           if fmt == "jag"
                           else (csr_to_bell, ell_spmm_cuda, bell_spmm))
    E, EH = conv(A, bm=8, bn=32), conv(A.T.tocsr(), bm=8, bn=32)
    x = (torch.from_numpy(rand64c(200, 3, rng=rng)) if complex_x
         else torch.randn(200, 3, generator=torch.Generator().manual_seed(0)))
    g = (torch.from_numpy(rand64c(90, 3, rng=rng)) if complex_x
         else torch.randn(90, 3, generator=torch.Generator().manual_seed(1)))
    xf = x.clone().requires_grad_()
    kernel_spmm(kernel, E, xf, EH).backward(g)
    assert xf.grad.dtype == x.dtype
    xp = x.clone().requires_grad_()
    plain(E, xp).backward(g)
    assert rel_err(xf.grad, xp.grad) < FN_TOL
    # the backward is the adjoint matrix's product, one call of the kernel
    if not complex_x:
        np.testing.assert_array_equal(xf.grad.numpy(),
                                      kernel(EH, g).numpy())
        xr = x.clone().requires_grad_()
        _SpmmFn.apply(kernel, E, EH, xr).backward(g)
        np.testing.assert_array_equal(xr.grad.numpy(), xf.grad.numpy())


def test_kernel_spmm_takes_the_function_only_for_a_graph(rng, monkeypatch):
    """K3/K4 launch through _SpmmFn only where the product carries the
    graph (the Function's host cost would slow the host-bound radial
    solve); otherwise the bare wrapper runs, and gives the same product."""
    from indigo_tpu_torch.ops import ell_spmm
    A = sp.csr_matrix(randM(20, 30, 0.2, rng=rng, dtype=np.float32))
    E, EH = csr_to_jag(A, bm=8, bn=32), csr_to_jag(A.T.tocsr(), bm=8, bn=32)
    calls = []
    apply = ell_spmm._SpmmFn.apply

    def counted(*a):
        calls.append(a)
        return apply(*a)
    monkeypatch.setattr(ell_spmm._SpmmFn, "apply", counted)
    x = torch.from_numpy(rand64c(30, 2, rng=rng))
    direct = kernel_spmm(jag_spmm_cuda, E, x, EH)
    with torch.no_grad():
        kernel_spmm(jag_spmm_cuda, E, x.clone().requires_grad_(), EH)
    assert not calls and direct.grad_fn is None
    y = kernel_spmm(jag_spmm_cuda, E, x.clone().requires_grad_(), EH)
    assert len(calls) == 1 and y.grad_fn is not None
    assert torch.equal(y.detach(), direct)


def test_operand_needs_grad_routes_and_refuses(rng):
    """Only the operand's gradient is ported: an operator tensor that
    requires grad raises under grad mode, and only there; a bare product
    (no adjoint) on CPU tensors takes the plain version, which autograd
    differentiates."""
    T = torch.zeros(2)
    _refuse_operator_grad("k", Tf=T, maps=None)
    with torch.no_grad():
        _refuse_operator_grad("k", Tf=T.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="maps is not ported"):
        _refuse_operator_grad("k", Tf=T, maps=torch.zeros(
            2, requires_grad=True))
    with pytest.raises(NotImplementedError, match="Tf is not ported"):
        _refuse_operator_grad("k", Tf=T.clone().requires_grad_())
    A = csr_to_jag(sp.csr_matrix(randM(20, 30, 0.2, rng=rng,
                                       dtype=np.float32)), bm=8, bn=32)
    x, g = torch.randn(30, 2), torch.randn(20, 2)
    xf, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    kernel_spmm(jag_spmm_cuda, A, xf).backward(g)
    jag_spmm(A, xp).backward(g)
    assert torch.equal(xf.grad, xp.grad)
