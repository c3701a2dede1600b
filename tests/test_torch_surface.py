"""The port's public surface against the reference's: ``Operator * ndarray``
(1e-5), the names the reference's ``__init__`` files export, and the
reference-shaped calls with TPU-only knobs, which the port accepts.
"""
import numpy as np
import pytest
import torch

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu.utils import randM
from indigo_tpu_torch.utils import rand64c, rel_err


# ---- Operator * numpy.ndarray ------------------------------------------

def _ops(rng):
    M = randM(40, 30, 0.2, rng=rng)
    D = rand64c(40, 30, rng=rng)
    return [(tit.SpMatrix(M), jit_.SpMatrix(M)),
            (tit.DenseMatrix(D), jit_.DenseMatrix(D)),
            (tit.DenseMatrix(D).H * tit.SpMatrix(M),
             jit_.DenseMatrix(D).H * jit_.SpMatrix(M))]


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("ndim", [1, 2])
def test_operator_times_ndarray(rng, i, ndim):
    op, ref = _ops(rng)[i]
    x = rand64c(*((30,) if ndim == 1 else (30, 3)), rng=rng)
    y = op * x
    assert isinstance(y, torch.Tensor) and y.dtype == torch.complex64
    want = np.asarray(ref * x)
    assert tuple(y.shape) == want.shape
    assert rel_err(y, want) < 1e-5
    assert torch.equal(op @ x, y)
    assert torch.equal(op * torch.from_numpy(x), y)
    back = op.H * np.asarray(want)
    assert rel_err(back, np.asarray(ref.H * want)) < 1e-5


def test_operator_times_ndarray_errors(rng):
    op, _ = _ops(rng)[0]
    with pytest.raises(ValueError):
        op * rand64c(31, rng=rng)
    with pytest.raises(TypeError):
        rand64c(40, rng=rng) * op       # no elementwise object array
    with pytest.raises(TypeError):
        op * "x"
    assert isinstance(2.0 * op, tit.Scale) and isinstance(op * 2, tit.Scale)


# ---- exported names ------------------------------------------------------

OPERATORS = ["Operator", "SpMatrix", "KBInterp", "DenseMatrix", "Diag",
             "UnscaledFFT", "CenteredDFT", "GridDFT", "Eye", "One", "Mask",
             "CropPad", "Perm", "Product", "Adjoint", "KronI", "BlockDiag",
             "VStack", "HStack", "Scale"]
TOP = OPERATORS + ["cg", "apgd", "fista", "max_eigen", "soft_thresh", "DWT",
                   "BlockedELL", "csr_to_bell", "bell_spmm", "get_backend",
                   "available_backends"]
SUBMODULES = ["operators", "transforms", "solvers", "sparse", "utils",
              "noncart", "oracle", "models", "wavelet", "toeplitz",
              "parallel", "backends", "native", "profiling", "checkpoint"]


@pytest.mark.parametrize("name", TOP + SUBMODULES)
def test_top_level_name_resolves(name):
    assert hasattr(jit_, name)          # the reference exports it
    assert hasattr(tit, name), name
    assert name in tit.__all__


def test_operator_exports_equal_the_reference():
    import indigo_tpu.operators as jo
    import indigo_tpu_torch.operators as to
    assert sorted(to.__all__) == sorted(jo.__all__) == sorted(OPERATORS)
    import indigo_tpu.solvers as js
    import indigo_tpu_torch.solvers as ts
    assert sorted(ts.__all__) == sorted(js.__all__)
    import indigo_tpu.transforms as jt
    import indigo_tpu_torch.transforms as tt
    assert sorted(tt.__all__) == sorted(jt.__all__)
    import indigo_tpu.models as jm
    import indigo_tpu_torch.models as tm
    assert sorted(tm.__all__) == sorted(jm.__all__)
    import indigo_tpu.wavelet as jw
    import indigo_tpu_torch.wavelet as tw
    assert sorted(tw.__all__) == sorted(jw.__all__)


def test_subpackage_exports():
    import indigo_tpu.analyses as ja
    import indigo_tpu.parallel as jp
    import indigo_tpu.utils as ju
    import indigo_tpu_torch.analyses as ta
    import indigo_tpu_torch.parallel as tp
    import indigo_tpu_torch.utils as tu
    for j, t in ((jp, tp), (ja, ta), (ju, tu)):
        assert sorted(t.__all__) == sorted(j.__all__)
        for name in j.__all__:
            assert hasattr(t, name), (t.__name__, name)
    assert len(tp.__all__) == 14
    from indigo_tpu_torch.noncart import zpad_mat, checkerboard  # noqa: F401
    assert tit.Diag(np.ones(3, np.complex64)).shape == (3, 3)


# ---- reference-shaped calls ---------------------------------------------

@pytest.mark.parametrize("grid", [(48, 64), (20, 20), (8, 8, 16)])
def test_tile_interp_apply_takes_the_reference_call(rng, grid):
    """tile_interp_apply(plan, x, adjoint, chunk) with x (N, K), against the
    reference's on the same plan geometry (1e-5)."""
    import jax.numpy as jnp
    from indigo_tpu.ops import tile_interp as jti
    from indigo_tpu_torch.ops import tile_interp as tti

    traj = rng.uniform(-0.5, 0.5, size=(120, len(grid)))
    tp = tti.plan_tile_interp(traj, grid, width=4, beta=6.5)
    jp = jti.plan_tile_interp(traj, grid, width=4, beta=6.5)
    N = int(np.prod(grid))
    x = rand64c(N, 2, rng=rng)
    y = rand64c(120, 2, rng=rng)
    fwd = tti.tile_interp_apply(tp, torch.from_numpy(x))
    assert rel_err(fwd, np.asarray(jti.tile_interp_apply(
        jp, jnp.asarray(x)))) < 1e-5
    adj = tti.tile_interp_apply(tp, y, adjoint=True, chunk=32)
    assert tuple(adj.shape) == (N, 2)
    assert rel_err(adj, np.asarray(jti.tile_interp_apply(
        jp, jnp.asarray(y), adjoint=True, chunk=32))) < 1e-5
    xr = x.real.copy()
    out = tti.tile_interp_apply(tp, xr)
    assert out.dtype == torch.float32
    assert rel_err(out, np.asarray(jti.tile_interp_apply(
        jp, jnp.asarray(xr)))) < 1e-5


def test_sense_normal_batched_takes_the_reference_layout_name(rng):
    from indigo_tpu_torch.ops.dft_fft import block_spectrum
    from indigo_tpu_torch.parallel import sense_normal_batched
    shape = (8, 8, 16)
    Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(np.float32)
    maps = torch.from_numpy(rand64c(2, *shape, rng=rng))
    xs = torch.from_numpy(rand64c(1, int(np.prod(shape)), rng=rng))
    Tb = torch.from_numpy(block_spectrum(Tf))
    a = sense_normal_batched(Tb, maps, xs, layout="pallas", sigma=False)
    b = sense_normal_batched(Tb, maps, xs, layout="kernel")
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        sense_normal_batched(Tb, maps, xs, layout="pallas", sigma=True)


def test_tpu_only_knobs_are_accepted(rng):
    from indigo_tpu import noncart as jn
    from indigo_tpu_torch import noncart as tn
    from indigo_tpu_torch import sparse as ts
    traj = rng.uniform(-0.5, 0.5, size=(40, 2))
    from indigo_tpu import native as jnat
    from indigo_tpu_torch import native as tnat
    a = tn.interp_mat(traj, (16, 16), impl="numpy")
    b = jn.interp_mat(traj, (16, 16), impl="numpy")
    assert abs(a - b).max() < 1e-7
    auto = tn.interp_mat(traj, (16, 16), impl="auto")
    if tnat.available() and jnat.available():
        assert (auto != jn.interp_mat(traj, (16, 16), impl="auto")).nnz == 0
    if tnat.available():
        assert (tn.interp_mat(traj, (16, 16), impl="native") != auto).nnz == 0
    else:
        assert (auto != a).nnz == 0
        with pytest.raises(RuntimeError):
            tn.interp_mat(traj, (16, 16), impl="native")
    p = rng.permutation(9)
    P = tit.Perm(p, dtype=np.complex64)
    assert P.dtype == torch.complex64
    x = torch.from_numpy(rand64c(9, 2, rng=rng))
    assert torch.equal(P * x, x[torch.from_numpy(p)])
    M = randM(20, 300, 0.05, rng=rng, dtype=np.float32)
    v = torch.from_numpy(rand64c(300, 2, rng=rng))
    want = torch.from_numpy(M.toarray()).to(torch.complex64) @ v
    for conv, mm in ((ts.csr_to_jag, ts.jag_spmm),
                     (ts.csr_to_bell, ts.bell_spmm),
                     (ts.csr_to_element, ts.element_spmm)):
        assert rel_err(mm(conv(M), v, precision="highest"), want) < 1e-5


# ---- the entry points ask for the card unless told otherwise -------------

def _card_calls():
    from indigo_tpu_torch.models import (cartesian_sense_op, centered_fft_op,
                                         nufft_op, sense_nufft_op)
    traj = np.linspace(-0.4, 0.4, 40)[:, None] * np.ones((1, 2))
    maps = np.ones((2, 8, 8), np.complex64)
    b = np.ones(6, np.complex64)
    return {
        "cartesian_sense_op": lambda **k: cartesian_sense_op(
            np.ones((8, 8), bool), maps, **k),
        "centered_fft_op": lambda **k: centered_fft_op((8, 8), **k),
        "nufft_op": lambda **k: nufft_op(traj, (8, 8), **k)[0],
        "sense_nufft_op": lambda **k: sense_nufft_op(traj, maps, **k)[0],
        "DWT": lambda **k: tit.DWT((8, 8), "haar", levels=1, **k),
        "cg": lambda **k: tit.cg(lambda v: 2.0 * v, b, maxiter=2, **k)[0],
        "apgd": lambda **k: tit.apgd(lambda v: 2.0 * v, lambda v, a: v, 0.5,
                                     b, maxiter=2, **k)[0],
        "max_eigen": lambda **k: tit.max_eigen(lambda v: 2.0 * v, 6, iters=2,
                                               **k),
    }


@pytest.mark.parametrize("name", ["cartesian_sense_op", "centered_fft_op",
                                  "nufft_op", "sense_nufft_op", "DWT", "cg",
                                  "apgd", "max_eigen"])
def test_entry_point_defaults_to_the_card(name):
    """Handed no tensor and no ``device``, an entry point goes to the card:
    where there is none it raises and does not quietly stay on the host;
    ``device="cpu"`` is how a caller asks for the host."""
    call = _card_calls()[name]
    out = call(device="cpu")
    dev = out.device
    assert dev is not None and dev.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
