"""Gridding on grids that the periodic tiling does not cover: ``KBInterp``
(the plan's halo folds back mod grid_shape), ``nufft_op``'s three branches
(``GridDFT`` / ``KBInterp * CenteredDFT`` / the ``fft="xla"`` chain) and
``SenseRecon`` at its default oversampling, against the reference.

Tolerances: 1e-5 for operators (f32, sums in another order than the
reference's tile gathers), 1e-4 for the reconstructed image and the CG
residuals, as tests/test_torch_recon.py; the image's bar is twice the
reference's own distance between its two gridding builds where that is
larger (``test_sense_recon_at_default_oversampling``).
"""
from functools import cache, partial

import numpy as np
import pytest

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu.models import SenseRecon as JRecon
from indigo_tpu.models import nufft_op as j_nufft_op
from indigo_tpu.ops import tile_interp as jti
from indigo_tpu_torch.convert import operator_from_reference
from indigo_tpu_torch import models as tmodels
from indigo_tpu_torch.models import SenseRecon
from indigo_tpu_torch.noncart import interp_mat
from indigo_tpu_torch.ops import tile_interp as tti
from indigo_tpu_torch.utils import rand64c, rel_err

from test_torch_native import BUILDERS, builder, pin_reference  # noqa: F401
from test_torch_recon import kooshball_traj, phantom, radial_traj, smooth_maps

# the model functions default to the card; these comparisons run on the host
nufft_op = partial(tmodels.nufft_op, device="cpu")
sense_nufft_op = partial(tmodels.sense_nufft_op, device="cpu")

TOL = 1e-5

# grid, width; every one has ext != grid on at least one axis, the 1-D and
# the (6, 20) grids have ext > 2 * grid (the reference's modular fold)
HALO_GRIDS = [((50, 50), 4), ((20, 20, 20), 4), ((150, 150), 4),
              ((30, 30, 30), 3), ((40,), 4), ((6, 20), 4), ((100,), 6)]


@pytest.mark.parametrize("grid,width", HALO_GRIDS)
def test_kbinterp_on_halo_tilings(rng, grid, width):
    traj = rng.uniform(-0.5, 0.5, size=(150, len(grid)))
    tp = tti.plan_tile_interp(traj, grid, width=width, beta=6.5)
    jp = jti.plan_tile_interp(traj, grid, width=width, beta=6.5)
    assert tuple(tp.ext) != tuple(grid) and tuple(tp.ext) == tuple(jp.ext)
    G, ref = tit.KBInterp(tp, device="cpu"), jit_.KBInterp(jp)
    assert G.shape == tuple(ref.shape)
    N = int(np.prod(grid))
    x = rand64c(N, 2, rng=rng)
    y = rand64c(150, 2, rng=rng)
    assert rel_err(G * x, np.asarray(ref * x)) < TOL
    assert rel_err(G.H * y, np.asarray(ref.H * y)) < TOL
    # and the gridding CSR, the spec of both
    A = interp_mat(traj, grid, width=width, beta=6.5)
    assert rel_err(G * x, A @ x) < TOL
    assert rel_err(G.H * y, A.conj().T @ y) < TOL
    conv = operator_from_reference(ref, device="cpu")
    assert rel_err(conv * x, G * x) < 1e-6
    f, b = G.cost(2)
    assert f > 0 and b > 0 and "width" in G._describe()


def test_ext_exceeds_twice_the_grid():
    """The small-grid case of the reference's fold (ext > 2 G)."""
    tp = tti.plan_tile_interp(np.array([[-0.5], [0.49], [0.0]]), (40,),
                              width=4, beta=6.5)
    assert tp.ext[0] > 2 * 40


NUFFT_CASES = [((100, 100), 1.5), ((40, 40, 40), 1.5), ((96, 96), 1.25),
               ((24, 24, 24), 1.25)]


@pytest.mark.parametrize("img,oversamp", NUFFT_CASES)
def test_nufft_op_halo_branch(rng, img, oversamp):
    traj = rng.uniform(-0.5, 0.5, size=(300, len(img)))
    A, plan = nufft_op(traj, img, oversamp=oversamp)
    ref, jplan = j_nufft_op(traj, img, oversamp=oversamp)
    assert [type(m).__name__ for m in A.modules()
            if isinstance(m, tit.KBInterp)] == ["KBInterp"]
    np.testing.assert_array_equal(plan.perm, jplan.perm)
    assert plan.grid_shape == jplan.grid_shape
    n = int(np.prod(img))
    x = rand64c(n, 2, rng=rng)
    y = rand64c(300, 2, rng=rng)
    assert rel_err(A * x, np.asarray(ref * x)) < TOL
    assert rel_err(A.H * y, np.asarray(ref.H * y)) < TOL


@pytest.mark.parametrize("img,oversamp,interp", [
    ((24, 24), 1.25, "tile"), ((32, 32), 1.5, "tile"),
    ((16, 16, 16), 1.5, "tile"), ((24, 24), 1.5, "sparse"), ((48,), 1.5, "auto")])
def test_nufft_op_xla_fft_chain(rng, img, oversamp, interp, builder):
    """fft="xla": G [. P] . (D_out F D_in) . Z . Da with the library FFT,
    against the reference's chain and the port's own fft="mm" form."""
    traj = rng.uniform(-0.5, 0.5, size=(200, len(img)))
    A, plan = nufft_op(traj, img, oversamp=oversamp, interp=interp,
                       fft="xla")
    ref, _ = j_nufft_op(traj, img, oversamp=oversamp, interp=interp,
                        fft="xla")
    kinds = [type(m).__name__ for m in A.modules()]
    assert "UnscaledFFT" in kinds and "CropPad" in kinds
    assert "CenteredDFT" not in kinds and "GridDFT" not in kinds
    n = int(np.prod(img))
    x = rand64c(n, 2, rng=rng)
    y = rand64c(200, 2, rng=rng)
    assert rel_err(A * x, np.asarray(ref * x)) < TOL
    assert rel_err(A.H * y, np.asarray(ref.H * y)) < TOL
    Amm, _ = nufft_op(traj, img, oversamp=oversamp, interp=interp, fft="mm")
    assert rel_err(A * x, Amm * x) < TOL


def test_nufft_op_auto_fft_rule_and_bad_arguments(rng):
    traj = rng.uniform(-0.5, 0.5, size=(50, 1))
    A, _ = nufft_op(traj, (400,), oversamp=1.5)     # grid 600 > 512: 'xla'
    assert "UnscaledFFT" in [type(m).__name__ for m in A.modules()]
    A, _ = nufft_op(traj, (64,), oversamp=1.5)      # grid 96: 'mm'
    assert "CenteredDFT" in [type(m).__name__ for m in A.modules()]
    with pytest.raises(ValueError):
        nufft_op(traj, (64,), fft="fftw")
    with pytest.raises(ValueError):
        nufft_op(traj, (64,), interp="nearest")


def test_sense_nufft_op_on_a_halo_grid(rng):
    traj = rng.uniform(-0.5, 0.5, size=(200, 2))
    maps = rand64c(3, 20, 20, rng=rng)
    from indigo_tpu.models import sense_nufft_op as j_sense
    A, _ = sense_nufft_op(traj, maps, oversamp=1.25)
    ref, _ = j_sense(traj, maps, oversamp=1.25)
    x = rand64c(400, 1, rng=rng)
    assert rel_err(A * x, np.asarray(ref * x)) < TOL


# 10 CG steps: at 20 the 40^2 image still agrees to 1e-4, but the two f32
# residual histories drift apart (1.2e-3) once they near their floor, as
# tests/test_torch_recon.py notes for its own 2D case.
RECON = {
    "16^3": dict(traj=lambda: kooshball_traj(96, 16), img=(16, 16, 16),
                 centers=[(0.3, 0.3, 0.5), (0.7, 0.6, 0.4)],
                 kw=dict(iters=10)),
    "40^2": dict(traj=lambda: radial_traj(60, 80), img=(40, 40),
                 centers=[(0.3, 0.3), (0.3, 0.7), (0.7, 0.3)],
                 kw=dict(iters=10)),
}

@cache
def _reference_recon(case, name):
    """The reference's SenseRecon of ``case`` on gridding build ``name``,
    whatever the test pinned."""
    cfg = RECON[case]
    with pytest.MonkeyPatch.context() as mp:
        pin_reference(mp, name)
        return JRecon(cfg["traj"](), smooth_maps(cfg["img"], cfg["centers"]),
                      **cfg["kw"])


@pytest.mark.parametrize("builder", BUILDERS + ["mixed"], indirect=True)
@pytest.mark.parametrize("case", sorted(RECON))
def test_sense_recon_at_default_oversampling(case, builder):
    """SenseRecon at oversamp 1.25 on grids 20^3 and 50^2, which the
    periodic tiling does not cover: residuals <= 1e-4, rhs and simulate
    <= 1e-5, on each gridding builder and on the reference's numpy with the
    port's native ("mixed").

    The bar of the image, and of the one the port solves from the
    reference's arrays, is max(1e-4, 2 d_ref), d_ref being the distance
    between the reference's own images on its two builders on the same
    data: at the 10th CG step of the 40^2 case one ulp in 14 % of the
    gridding weights moves the reference's image by 9.5e-5 against
    itself."""
    cfg = RECON[case]
    traj = cfg["traj"]()
    maps = smooth_maps(cfg["img"], cfg["centers"])
    ref_build = "native" if builder == "native" else "numpy"
    j = _reference_recon(case, ref_build)
    p = SenseRecon(traj, maps, device="cpu", **cfg["kw"])
    assert any(isinstance(m, tit.KBInterp) for m in p.A.modules())
    assert abs(p.lamda - j.lamda) <= 1e-5 * j.lamda
    y = p.simulate(phantom(cfg["img"]))
    assert rel_err(y, np.asarray(j.simulate(phantom(cfg["img"])))) < TOL
    y = y + 0.01 * np.abs(y).max() * rand64c(y.shape[0], rng=3)
    ys = j.plan.sort_samples(y, ncoil=j.nc)[:, None].astype(np.complex64)
    rr, ri = j._rhs_fn(j._A_d, j._wd, ys)
    assert rel_err(p.rhs(y), np.asarray(rr) + 1j * np.asarray(ri)) < TOL
    xp, rp = p(y, return_resids=True)
    out = {b: _reference_recon(case, b)(y, return_resids=True)
           for b in BUILDERS}
    xj, rj = out[ref_build]
    d_ref = rel_err(np.asarray(out["native"][0]),
                    np.asarray(out["numpy"][0]))
    err, bar = rel_err(xp, np.asarray(xj)), max(1e-4, 2 * d_ref)
    assert err < bar, f"image rel_err {err} over max(1e-4, 2 d_ref), " \
        f"d_ref {d_ref}"
    assert rel_err(rp, np.asarray(rj).ravel()) < 1e-4
    # the pipeline rebuilt from the reference's arrays takes the halo plan
    gplan = j.A.left.child.left.plan     # KronI(KBInterp . CenteredDFT)
    from indigo_tpu.toeplitz import toeplitz_kernel as j_toeplitz_kernel
    from indigo_tpu_torch.convert import state_from_reference_arrays
    Tf = j_toeplitz_kernel(traj, cfg["img"], oversamp=1.25, width=4,
                           weights=j._w_user, warn=False)
    state = state_from_reference_arrays(
        Tf=Tf, maps=maps, w_sorted=j._w_sorted, perm=j.plan.perm,
        deapod=j.plan.deapod, tid=np.asarray(gplan.tid),
        wfac=[np.asarray(w) for w in gplan.wfac],
        grid_shape=gplan.grid_shape, tile=gplan.tile, ext=gplan.ext,
        nt=gplan.nt, pad_lo=gplan.pad_lo, width=gplan.width,
        lamda=j.lamda, iters=j.iters)
    q = SenseRecon.from_arrays(state, device="cpu")
    err = rel_err(q(y), np.asarray(xj))
    assert err < bar, f"from_arrays image rel_err {err} over " \
        f"max(1e-4, 2 d_ref), d_ref {d_ref}"
