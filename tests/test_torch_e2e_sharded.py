"""The port's multi-device END-TO-END recon (k-space in, image out) on 8
gloo ranks (CPU), against the reference's ``SenseReconSharded`` on its
virtual 8-device mesh and against the port's single-device ``SenseRecon``.

Same structure as tests/test_torch_parallel.py: module-level rank functions
(no jax at this module's top level, since the spawned ranks import it), one
launch per group of assertions, rank 0's numpy results compared here.
Tolerances are those of tests/test_e2e_sharded.py: 1e-4 for a CG solve
against another pipeline, 1e-6 for the same pipeline called two ways. The
trajectories are a kooshball and 2D radial spokes, and the maps smooth, so
that the solves are well conditioned. Both packages grid on the builder the
test pins (tests/test_torch_native.py), the ranks too: the solves on each of
the two, the rest on the native one.
"""
from functools import cache

import numpy as np
import pytest
import torch

from indigo_tpu_torch import convert
from indigo_tpu_torch.models import SenseRecon
from indigo_tpu_torch.parallel import (
    SenseReconSharded, make_mesh, sense_recon_sharded)
from indigo_tpu_torch.parallel.dryrun import (
    dryrun_multichip, dryrun_ranks, recon_at_grid)
from indigo_tpu_torch.parallel.launch import launch
from indigo_tpu_torch.utils import rand64c, rel_err

NRANKS = 8
BUILDERS = ["native", "numpy"]     # as tests/test_torch_native.py's


def run(fn, *args):
    return launch(fn, NRANKS, args=args, device="cpu", timeout=480.0)


@pytest.fixture
def builder(request, monkeypatch):
    """tests/test_torch_native.py's ``builder``, imported when a test runs:
    the ranks import this module, whose top level imports no jax."""
    from test_torch_native import pin_builder

    return pin_builder(monkeypatch, getattr(request, "param", "native"))


def pin_rank(builder):
    """In a rank, the port's gridding builder of the parent's pin, which
    does not reach another process."""
    from indigo_tpu_torch import native

    if builder == "numpy":
        native.available = lambda: False
    elif not native.available():
        raise RuntimeError(f"no native gridding in the rank: {native._error}")


def raises(exc, match, fn, *args, **kw):
    try:
        fn(*args, **kw)
    except exc as e:
        return match in str(e)
    return False


def kooshball(nspokes, nread):
    g = (1 + 5 ** 0.5) / 2
    i = np.arange(nspokes)
    z = (2 * i + 1) / nspokes - 1
    th = 2 * np.pi * i / g
    dirs = np.stack([z, np.sqrt(1 - z * z) * np.cos(th),
                     np.sqrt(1 - z * z) * np.sin(th)], 1)
    r = (np.arange(nread) + 0.5) / nread * 0.5
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)


def radial2d(nspokes, nread):
    th = np.pi * (np.arange(nspokes) + 0.5) / nspokes
    dirs = np.stack([np.cos(th), np.sin(th)], 1)
    r = np.concatenate([-(np.arange(nread // 2) + 0.5)[::-1],
                        (np.arange(nread // 2) + 0.5)]) / nread * 0.5 * 2
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 2)


def smooth_maps(nc, shape, rng):
    """Low-frequency random coil maps (coil combination non-trivial but well
    conditioned), any rank."""
    nd = len(shape)
    big = np.zeros((nc,) + tuple(shape), np.complex64)
    big[(slice(None),) + (slice(0, 5),) * nd] = rand64c(nc, *(5,) * nd,
                                                        rng=rng)
    big = np.fft.ifftn(big, axes=tuple(range(1, nd + 1)))
    return (big / np.abs(big).max() + 0.3).astype(np.complex64)


def phantom(shape):
    zz, yy, xx = np.mgrid[[slice(0, s) for s in shape]].astype(np.float64)
    zz, yy, xx = (a / s for a, s in zip((zz, yy, xx), shape))
    img = np.zeros(shape, np.complex64)
    img[((zz - .5) / .35) ** 2 + ((yy - .5) / .4) ** 2
        + ((xx - .5) / .3) ** 2 <= 1] = 1.0
    img[((zz - .45) / .12) ** 2 + ((yy - .55) / .1) ** 2
        + ((xx - .5) / .15) ** 2 <= 1] += 0.6j
    return img


def _state(rec):
    """The port object's host-side state under the names of
    ``convert.sharded_state_from_reference`` (rank 0's blocks)."""
    st = {"perm": rec.perm, "lamda": rec.lamda, "grid_shape": rec.grid_shape,
          "nt": rec.nt, "Bmats": [B.numpy() for B in rec._Bmats],
          "dam": rec._dam.numpy(), "Tf": rec._Tf.numpy()}
    if rec.ndim == 3:
        st.update(chunks=rec._chunks, w_chunks=rec._w_chunks)
    else:
        st["w_sorted"] = rec._w_sorted
    return st


# ---- 3D ------------------------------------------------------------------------

def ranks_3d(builder, traj, maps, y, traj_small, y_small):
    pin_rank(builder)
    mesh = make_mesh(device="cpu", vol=8)
    out = {}
    kw = dict(oversamp=2.0, width=4, iters=8)
    rec = SenseReconSharded(traj, maps, mesh, dcf="radial", **kw)
    x, resids = rec(y, return_resids=True)
    out.update(x=x, resids=resids, state=_state(rec), device=str(rec.device))

    # auto-padding: oversamp 1.25 -> grid 40, nt_z = 10, which 8 ranks do
    # not divide: grid_z is padded up to a tile*mesh multiple
    maps2 = maps[:2]
    pad = SenseReconSharded(traj_small, maps2, mesh, dcf="radial",
                            oversamp=1.25, width=4, iters=6)
    out["pad_grid"], out["pad_nt"], out["pad_tile"] = (
        pad.grid_shape, pad.nt, pad.tile)
    out["pad_lamda"] = pad.lamda
    out["x_pad"] = pad(y_small)

    # validation, the class called twice and the one-shot function
    out["errors"] = [
        raises(ValueError, "image dims", SenseReconSharded, kooshball(36, 32),
               np.ones((2, 36, 36, 36), np.complex64), mesh),
        raises(ValueError, "samples", rec, np.zeros(7, np.complex64)),
        raises(ValueError, "supported", SenseReconSharded, traj, maps[:, 0],
               mesh),
    ]
    small = SenseReconSharded(traj_small, maps2, mesh, oversamp=2.0, width=4,
                              iters=4)
    out["x_cls"] = small(y_small)
    out["x_fn"] = sense_recon_sharded(traj_small, maps2, y_small, mesh,
                                      oversamp=2.0, width=4, iters=4)
    out["x_tensor"] = small(torch.from_numpy(y_small).reshape(2, -1))
    return out


@pytest.fixture
def run_3d(builder):
    return _run_3d(builder)


@cache
def _run_3d(builder):
    rng = np.random.default_rng(1234)
    n, nc = 32, 3
    shape = (n, n, n)
    traj, traj_small = kooshball(3 * n, n), kooshball(2 * n, n)
    maps = smooth_maps(nc, shape, rng)
    kw = dict(oversamp=2.0, width=4, iters=8)
    rec1 = SenseRecon(traj, maps, dcf="radial", device="cpu", **kw)
    y = rec1.simulate(phantom(shape))
    y = y + 0.005 * np.abs(y).mean() * rand64c(*y.shape, rng=rng)
    one = SenseRecon(traj_small, maps[:2], dcf="radial", device="cpu",
                     oversamp=1.25, width=4, iters=6)
    y_small = one.simulate(phantom(shape))
    out = run(ranks_3d, builder, traj, maps, y, traj_small, y_small)
    return dict(traj=traj, maps=maps, y=y, rec1=rec1, traj_small=traj_small,
                y_small=y_small, one=one, shape=shape, out=out)


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
def test_sharded_e2e_matches_reference_and_single_device(run_3d):
    from indigo_tpu.parallel import make_mesh as j_make_mesh
    from indigo_tpu.parallel.e2e import SenseReconSharded as JSharded

    r, out = run_3d, run_3d["out"]
    ref = JSharded(r["traj"], r["maps"], j_make_mesh(vol=8), dcf="radial",
                   oversamp=2.0, width=4, iters=8)
    xr, rr = ref(r["y"], return_resids=True)
    assert out["device"] == "cpu"
    assert out["x"].shape == r["shape"] and out["resids"].shape == (8,)
    assert out["x"].dtype == np.complex64
    assert rel_err(out["x"], np.asarray(xr)) < 1e-4
    assert rel_err(out["resids"], np.asarray(rr)) < 1e-4
    # the port's own single-device pipeline on the same acquisition
    assert out["state"]["lamda"] == pytest.approx(r["rec1"].lamda, rel=1e-6)
    assert rel_err(out["x"], r["rec1"](r["y"])) < 1e-4


def test_sharded_e2e_state_equals_the_reference(run_3d):
    """Sample order, chunks, weights, DFT factors, deapodised maps, spectrum
    and lamda: what ``convert.sharded_state_from_reference`` reads off the
    reference object against the port's (rank 0 holds block 0 of the
    sharded arrays)."""
    from indigo_tpu.parallel import make_mesh as j_make_mesh
    from indigo_tpu.parallel.e2e import SenseReconSharded as JSharded

    r, st = run_3d, run_3d["out"]["state"]
    ref = convert.sharded_state_from_reference(
        JSharded(r["traj"], r["maps"], j_make_mesh(vol=8), dcf="radial",
                 oversamp=2.0, width=4, iters=8))
    assert st["grid_shape"] == ref["grid_shape"] and st["nt"] == ref["nt"]
    for key in ("perm", "chunks", "w_chunks"):
        np.testing.assert_array_equal(st[key], ref[key])
    assert st["lamda"] == pytest.approx(ref["lamda"], rel=1e-5)
    for a, b in zip(st["Bmats"], ref["Bmats"]):
        assert rel_err(a, b) < 1e-6
    nz, ny2 = r["shape"][0] // NRANKS, 2 * r["shape"][1] // NRANKS
    assert rel_err(st["dam"], ref["dam"][:, :nz]) < 1e-6
    assert rel_err(st["Tf"], ref["Tf"][:, :ny2]) < 1e-5


def test_sharded_e2e_oneshot_and_validation(run_3d):
    out = run_3d["out"]
    assert all(out["errors"])
    assert rel_err(out["x_fn"], out["x_cls"]) < 1e-6
    assert rel_err(out["x_tensor"], out["x_cls"]) < 1e-6


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
def test_sharded_e2e_autopad_grid_same_geometry(run_3d):
    """The auto-padded grid (oversamp 1.25 at n=32: nominal grid 40, z
    padded to a tile*mesh multiple) against the reference on the same mesh
    (so the same padded grid) and against the port's single-device solve
    gridded on that padded grid, both at 1e-4; the nominal-grid SenseRecon
    differs from it by the gridding error only."""
    from indigo_tpu.parallel import make_mesh as j_make_mesh
    from indigo_tpu.parallel.e2e import SenseReconSharded as JSharded

    r, out = run_3d, run_3d["out"]
    grid = out["pad_grid"]
    assert out["pad_nt"][0] % NRANKS == 0 and grid == (64, 40, 40)
    assert all(g % t == 0 for g, t in zip(grid, out["pad_tile"]))
    maps2 = r["maps"][:2]
    ref = JSharded(r["traj_small"], maps2, j_make_mesh(vol=8), dcf="radial",
                   oversamp=1.25, width=4, iters=6)
    assert tuple(ref.grid_shape) == grid
    assert rel_err(out["x_pad"], np.asarray(ref(r["y_small"]))) < 1e-4
    x_one = recon_at_grid(r["traj_small"], maps2, r["y_small"], grid,
                          oversamp=1.25, width=4, lamda=out["pad_lamda"],
                          iters=6, device="cpu")
    assert out["x_pad"].shape == r["shape"]
    assert rel_err(out["x_pad"], x_one) < 1e-4
    assert rel_err(out["x_pad"], r["one"](r["y_small"])) < 1e-2


# ---- 2D batches ------------------------------------------------------------------

def ranks_2d(builder, traj, maps, y, w, y_pm):
    pin_rank(builder)
    mesh = make_mesh(device="cpu", vol=8)
    kw = dict(oversamp=2.0, width=4)
    rec = SenseReconSharded(traj, maps, mesh, dcf="radial", iters=6, **kw)
    x, resids = rec(y, return_resids=True)
    pm = SenseReconSharded(traj, maps, mesh, dcf="pipe_menon", iters=4, **kw)
    return {
        "ndim": rec.ndim, "x": x, "resids": resids, "x_one": rec(y[0]),
        "state": _state(rec), "pm_grid": pm.grid_shape, "x_pm": pm(y_pm),
        "x_w": SenseReconSharded(traj, maps, mesh, dcf=w, iters=4,
                                 **kw)(y_pm),
        "bad_batch": raises(ValueError, "2D batch", rec, y[:, :, :5]),
    }


@pytest.fixture
def run_2d(builder):
    return _run_2d(builder)


@cache
def _run_2d(builder):
    from indigo_tpu_torch.noncart import pipe_menon_dcf

    rng = np.random.default_rng(1234)
    n, nc, S = 32, 2, 3
    traj = radial2d(3 * n, n)
    maps = smooth_maps(nc, (n, n), rng)
    rec1 = SenseRecon(traj, maps, dcf="radial", device="cpu", oversamp=2.0,
                      width=4, iters=6)
    img = np.zeros((n, n), np.complex64)
    img[8:24, 10:22] = 1.0
    y = np.stack([rec1.simulate(np.roll(img, 2 * s, axis=0)).reshape(nc, -1)
                  for s in range(S)])                       # (S, nc, M)
    w = pipe_menon_dcf(traj, (64, 64), width=4, device="cpu")
    y_pm = rand64c(1, nc, len(traj), rng=rng)
    out = run(ranks_2d, builder, traj, maps, y, w, y_pm)
    return dict(traj=traj, maps=maps, y=y, rec1=rec1, out=out, y_pm=y_pm, n=n)


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
def test_sharded_e2e_2d_batch_matches_reference_and_single_device(run_2d):
    """S = 3 acquisitions padded to the 8 ranks, each slice solved on its
    own rank."""
    from indigo_tpu.parallel import make_mesh as j_make_mesh
    from indigo_tpu.parallel.e2e import SenseReconSharded as JSharded

    r, out = run_2d, run_2d["out"]
    n, S = r["n"], 3
    assert out["ndim"] == 2
    assert out["x"].shape == (S, n, n) and out["resids"].shape == (6, S)
    ref = JSharded(r["traj"], r["maps"], j_make_mesh(vol=8), dcf="radial",
                   oversamp=2.0, width=4, iters=6)
    xr, rr = ref(r["y"], return_resids=True)
    assert rel_err(out["x"], np.asarray(xr)) < 1e-4
    assert rel_err(out["resids"], np.asarray(rr)) < 1e-4
    for s in range(S):
        assert rel_err(out["x"][s], r["rec1"](r["y"][s])) < 1e-4
    # single-acquisition convenience form
    assert out["x_one"].shape == (1, n, n)
    assert rel_err(out["x_one"][0], out["x"][0]) < 1e-6
    assert out["bad_batch"]
    st = out["state"]
    rs = convert.sharded_state_from_reference(ref)
    np.testing.assert_array_equal(st["perm"], rs["perm"])
    np.testing.assert_array_equal(st["w_sorted"], rs["w_sorted"])
    assert rel_err(st["dam"], rs["dam"]) < 1e-6


def test_sharded_e2e_pipe_menon_dcf(run_2d):
    """dcf='pipe_menon' computes the weights on the pipeline's own grid:
    the same recon as passing them in."""
    out = run_2d["out"]
    assert out["pm_grid"] == (64, 64)
    assert rel_err(out["x_pm"], out["x_w"]) < 1e-6


# ---- the whole slice ----------------------------------------------------------------

def test_dryrun_sequence_on_8_ranks(capsys):
    """The reference's dryrun_multichip sequence in the port: (slice, coil)
    solve, distributed FFT, slab and pencil solves, the end-to-end pipeline
    and its auto-padded form; every error is asserted inside the ranks
    (a failing one fails the launch) and again here."""
    err = dryrun_multichip(NRANKS, device="cpu", timeout=480.0)
    assert list(err) == ["slice x coil recon", "distributed FFT",
                         "slab volume recon", "pencil volume recon",
                         "e2e k-space->image recon", "auto-padded e2e recon"]
    assert all(v < 1e-4 for v in err.values())
    assert "dryrun_multichip(8, cpu): OK" in capsys.readouterr().out


def test_recon_at_grid_defaults_to_the_card():
    """With no ``device`` the single-device comparison solve goes to the
    card; where there is none it raises and does not stay on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recon_at_grid(np.zeros((4, 3)), np.ones((1, 4, 4, 4), np.complex64),
                      np.zeros((1, 4), np.complex64), (6, 6, 6))


def test_dryrun_on_an_odd_rank_count():
    """Three ranks: a (3, 1) mesh whose 'coil' axis has size 1, no pencil."""
    err = launch(dryrun_ranks, 3, args=(3, "cpu"), device="cpu",
                 timeout=480.0)
    assert "pencil volume recon" not in err and len(err) == 5
    assert all(v < 1e-4 for v in err.values())
