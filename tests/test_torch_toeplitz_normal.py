"""ToeplitzNormal and sense_normal_toeplitz: the port vs the reference.

The same raw spectrum, maps and images go through both packages. The
reference's "pallas" method runs its K2 kernels in interpret mode on the
CPU. Tolerances: 2e-4 against those (their bf16x3 Karatsuba products, the
bar of tests/test_dft_pallas.py); 1e-5 against the f32 "dft" and "fft"
operators and the padded FFTs; 1e-4 for ``cg`` on the tree (rounding grows
over the iterations; the lamda keeps f32 CG well conditioned).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import indigo_tpu as jit_
from indigo_tpu.models import sense_nufft_op as j_sense_nufft_op
from indigo_tpu.ops.toeplitz_fft import fft_pad2x as j_fft_pad2x
from indigo_tpu.ops.toeplitz_fft import ifft_crop2x as j_ifft_crop2x
from indigo_tpu.toeplitz import ToeplitzNormal as JToeplitz
from indigo_tpu.toeplitz import sense_normal_toeplitz as j_tree
from indigo_tpu.toeplitz import toeplitz_kernel as j_toeplitz_kernel
import indigo_tpu_torch as it
from indigo_tpu_torch.convert import toeplitz_from_reference
from indigo_tpu_torch.ops.dft_cuda import toeplitz_apply_cuda
from indigo_tpu_torch.ops.toeplitz_fft import fft_pad2x, ifft_crop2x
from indigo_tpu_torch.toeplitz import ToeplitzNormal, sense_normal_toeplitz
from indigo_tpu_torch.utils import rand64c, rel_err


def _spectrum(rng, img):
    return rng.standard_normal(tuple(2 * s for s in img)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,axes", [((6, 10), (0, 1)),
                                        ((4, 6, 8), (0, 2)),
                                        ((3, 8, 5, 2), (1, 2))])
def test_padded_ffts_match_reference(rng, shape, axes):
    x = rand64c(*shape, rng=rng)
    ref = np.asarray(j_fft_pad2x(jnp.asarray(x), axes))
    out = fft_pad2x(_t(x), axes)
    assert out.shape == ref.shape
    assert rel_err(out, ref) < 1e-5
    X = rand64c(*ref.shape, rng=rng)
    ref = np.asarray(j_ifft_crop2x(jnp.asarray(X), axes))
    out = ifft_crop2x(_t(X), axes)
    assert out.shape == ref.shape == x.shape
    assert rel_err(out, ref) < 1e-5


def test_padded_ffts_real_input_is_promoted(rng):
    x = rng.standard_normal((8, 6)).astype(np.float32)
    out = fft_pad2x(_t(x), (0, 1))
    assert out.dtype == torch.complex64
    assert rel_err(out, np.asarray(j_fft_pad2x(jnp.asarray(x), (0, 1)))) \
        < 1e-5


@pytest.mark.parametrize("img", [(8, 8, 16), (8, 136, 8)])
def test_pallas_method_matches_reference_kernel(rng, img):
    Tf = _spectrum(rng, img)
    x = rand64c(int(np.prod(img)), 2, rng=rng)
    ref = np.asarray(JToeplitz(Tf, img, method="pallas") * x)
    K = ToeplitzNormal(Tf, img, method="pallas", device="cpu")
    before = toeplitz_apply_cuda.launches
    out = K * _t(x)
    assert toeplitz_apply_cuda.launches == before   # CPU: the plain version
    assert rel_err(out, ref) < 2e-4


@pytest.mark.parametrize("method", ["dft", "fft"])
@pytest.mark.parametrize("img", [(8, 8, 16), (12, 16)])
def test_dft_and_fft_methods_match_reference(rng, img, method):
    Tf = _spectrum(rng, img)
    x = rand64c(int(np.prod(img)), 3, rng=rng)
    ref = np.asarray(JToeplitz(Tf, img, method=method) * x)
    out = ToeplitzNormal(Tf, img, method=method, device="cpu") * _t(x)
    assert rel_err(out, ref) < 1e-5


def test_auto_method_resolves_by_volume(rng):
    assert ToeplitzNormal(_spectrum(rng, (8, 8, 16)), (8, 8, 16),
                          device="cpu").method \
        == "pallas"
    assert ToeplitzNormal(_spectrum(rng, (12, 16)), (12, 16),
                          device="cpu").method == "dft"
    assert ToeplitzNormal(_spectrum(rng, (12, 8, 8)), (12, 8, 8),
                          device="cpu").method \
        == "dft"
    with pytest.raises(ValueError):
        ToeplitzNormal(_spectrum(rng, (12, 8, 8)), (12, 8, 8),
                       method="pallas", device="cpu")
    with pytest.raises(ValueError):
        ToeplitzNormal(_spectrum(rng, (8, 8)), (8, 8), method="mm",
                       device="cpu")


@pytest.mark.parametrize("method,img", [("pallas", (8, 8, 16)),
                                        ("dft", (12, 16)),
                                        ("fft", (8, 8, 16))])
def test_from_reference_applies_the_same_operator(rng, method, img):
    Tf = _spectrum(rng, img)
    jk = JToeplitz(Tf, img, name="T", method=method)
    pk = toeplitz_from_reference(jk, device="cpu")
    assert pk.method == method and pk.img_shape == img and pk.name == "T"
    np.testing.assert_array_equal(
        pk.T.numpy(),
        ToeplitzNormal(Tf, img, method=method, device="cpu").T.numpy())
    x = rand64c(int(np.prod(img)), 2, rng=rng)
    tol = 2e-4 if method == "pallas" else 1e-5
    assert rel_err(pk * _t(x), np.asarray(jk * x)) < tol


@pytest.mark.parametrize("method", ["pallas", "dft", "fft"])
def test_self_adjoint(rng, method):
    img = (8, 8, 8)
    K = ToeplitzNormal(_spectrum(rng, img), img, method=method, device="cpu")
    x, y = (_t(rand64c(512, 1, rng=rng)) for _ in range(2))
    lhs = torch.vdot((K * x).ravel(), y.ravel())
    rhs = torch.vdot(x.ravel(), (K * y).ravel())
    assert abs(lhs - rhs) / abs(lhs) < 1e-5
    np.testing.assert_array_equal((K.H * x).numpy(), (K * x).numpy())


def test_shape_cost_describe_and_sigma_basis(rng):
    img = (8, 8, 16)
    Tf = _spectrum(rng, img)
    K = ToeplitzNormal(Tf, img, name="Toep", device="cpu")
    jk = JToeplitz(Tf, img, name="Toep", method="dft")
    assert K.shape == jk.shape == (1024, 1024)
    assert K.dtype == torch.complex64
    assert K.cost(3) == jk.cost(3)
    assert K._describe() == jk._describe()
    assert "Toep[8, 8, 16]" in repr(K)
    Ks, P = K.sigma_basis()
    assert Ks is K and P is None


def test_spectrum_is_module_state(rng):
    """The spectrum is a buffer, so ``.to()`` moves it and a state_dict
    carries the whole operator."""
    img = (8, 8, 8)
    K = ToeplitzNormal(_spectrum(rng, img), img, device="cpu")
    assert list(K.state_dict()) == ["T"]
    K2 = ToeplitzNormal(np.zeros((16, 16, 16), np.float32), img, device="cpu")
    K2.load_state_dict(K.state_dict())
    x = _t(rand64c(512, 2, rng=rng))
    np.testing.assert_array_equal((K2 * x).numpy(), (K * x).numpy())


@pytest.mark.parametrize("K", [1, 2])
def test_sense_tree_matches_reference_tree(rng, K):
    img, nc = (8, 8, 16), 3
    Tf = _spectrum(rng, img)
    maps = rand64c(nc, *img, rng=rng)
    x = rand64c(int(np.prod(img)), K, rng=rng)
    ref = np.asarray(j_tree(Tf, maps) * x)
    N = sense_normal_toeplitz(Tf, maps, device="cpu")
    out = N * _t(x)
    assert N.shape == (1024, 1024)
    assert rel_err(out, ref) < 1e-5


def test_sense_tree_matches_batched(rng):
    from indigo_tpu_torch.parallel.recon import sense_normal_batched

    img, nc = (8, 16, 8), 3
    Tf = _spectrum(rng, img)
    maps = rand64c(nc, *img, rng=rng)
    x = rand64c(int(np.prod(img)), 2, rng=rng)
    out = sense_normal_toeplitz(Tf, maps, device="cpu") * _t(x)
    ref = sense_normal_batched(_t(Tf), _t(maps), _t(x.T.copy()))
    assert rel_err(out, ref.T) < 1e-5


def _sense_problem(rng):
    img, nc = (12, 12), 3
    traj = rng.random((80, 2)) - 0.5
    maps = rand64c(nc, *img, rng=rng)
    A, _ = j_sense_nufft_op(traj, maps, oversamp=2.0, width=6, sort=False)
    y = np.asarray(A * rand64c(144, 1, rng=rng))
    AHy = np.asarray(A.H * y)
    Tf = j_toeplitz_kernel(traj, img, oversamp=2.0, width=6)
    return Tf, maps, AHy


@pytest.mark.parametrize("tol,maxiter", [(0.0, 25), (1e-4, 100)])
def test_cg_on_tree_matches_reference(rng, tol, maxiter):
    Tf, maps, AHy = _sense_problem(rng)
    lam = 0.2 * float(np.abs(Tf).max())
    xr, ir = jit_.cg(j_tree(Tf, maps), AHy, lamda=lam, tol=tol,
                     maxiter=maxiter)
    xp, ip = it.cg(sense_normal_toeplitz(Tf, maps, device="cpu"), _t(AHy),
                   lamda=lam, tol=tol, maxiter=maxiter)
    assert int(ip["iters"]) == int(ir["iters"])
    assert rel_err(xp, np.asarray(xr)) < 1e-4


def test_cg_on_tree_solves_the_normal_equations(rng):
    Tf, maps, AHy = _sense_problem(rng)
    lam = 0.2 * float(np.abs(Tf).max())
    N = sense_normal_toeplitz(Tf, maps, device="cpu")
    x, info = it.cg(N, _t(AHy), lamda=lam, tol=0.0, maxiter=40,
                    history=True)
    res = (N * x + lam * x) - _t(AHy)
    assert rel_err(res, np.zeros_like(AHy)) < 1e-4 * np.linalg.norm(AHy)
    assert info["resids"].shape == (40,) and float(info["resid"]) < 1e-4
