"""SenseRecon: the port vs the reference on the same trajectory and maps.

Tolerances: rhs and simulate 1e-5 (operator level, f32); the image and the
CG residuals 1e-4 (rounding differences grow through the iterations). The
2D case is the tests/test_serving.py geometry at 30 CG steps: it reaches
~1e-6 relative residual there, and further steps sit on the f32 floor, where
the two frameworks' rounding drives the residuals apart. Both packages grid
on the builder the test pins (tests/test_torch_native.py): the solves on
each of the two, the operator-level checks on the native one.
"""
from functools import cache

import numpy as np
import pytest
import torch

from indigo_tpu.models import SenseRecon as JRecon
from indigo_tpu.toeplitz import toeplitz_kernel as j_toeplitz_kernel
from indigo_tpu_torch.convert import state_from_reference_arrays
from indigo_tpu_torch.models import SenseRecon
from indigo_tpu_torch.models.recon import host_copy
from indigo_tpu_torch.utils import rand64c, rel_err

from test_torch_native import BUILDERS, builder  # noqa: F401


def kooshball_traj(nspokes, nread, seed=0):
    rng = np.random.default_rng(seed)
    u, v = rng.random(nspokes), rng.random(nspokes)
    th, ph = np.arccos(2 * u - 1), 2 * np.pi * v
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], axis=1)
    r = (np.arange(nread) - nread // 2) / nread
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)


def radial_traj(nspokes, nread):
    ang = np.pi * np.arange(nspokes) / nspokes
    r = (np.arange(nread) - nread // 2) / nread
    return np.stack([np.outer(np.cos(ang), r).ravel(),
                     np.outer(np.sin(ang), r).ravel()], axis=1)


def smooth_maps(img_shape, centers):
    grids = np.mgrid[tuple(slice(0, n) for n in img_shape)] / img_shape[0]
    maps = []
    for c in centers:
        r2 = sum((g - ci) ** 2 for g, ci in zip(grids, c))
        ph = 2 * np.pi * sum(ci * g for g, ci in zip(grids[:2], c))
        maps.append((0.5 + np.exp(-r2 * 3)) * np.exp(1j * ph))
    return np.asarray(maps, dtype=np.complex64)


def phantom(img_shape):
    grids = np.mgrid[tuple(slice(0, n) for n in img_shape)] / img_shape[0]
    r2 = sum((g - .5) ** 2 for g in grids)
    return np.exp(-r2 * 9).astype(np.complex64)


CONFIGS = {
    "3d": dict(traj=lambda: kooshball_traj(96, 16), img=(16, 16, 16),
               centers=[(0.3, 0.3, 0.5), (0.7, 0.6, 0.4)],
               kw=dict(oversamp=2.0, width=4, iters=10)),
    "2d": dict(traj=lambda: radial_traj(48, 48), img=(24, 24),
               centers=[(0.3, 0.3), (0.3, 0.7), (0.7, 0.3), (0.7, 0.7)],
               kw=dict(oversamp=2.0, width=5, iters=30)),
}


@cache
def _pair(config, builder):
    cfg = CONFIGS[config]
    traj = cfg["traj"]()
    maps = smooth_maps(cfg["img"], cfg["centers"])
    j = JRecon(traj, maps, **cfg["kw"])
    p = SenseRecon(traj, maps, device="cpu", **cfg["kw"])
    return j, p, traj, maps, cfg


@pytest.fixture(params=sorted(CONFIGS))
def pair(request, builder):
    """The reference's and the port's pipelines on the gridding build the
    test pinned (``builder``), built once per configuration and build."""
    return _pair(request.param, builder)


def test_layout_off_cuda_is_block(pair):
    _, p, _, _, _ = pair
    assert p.layout == "block"


def test_simulate_matches(pair):
    j, p, _, _, cfg = pair
    x = phantom(cfg["img"])
    assert rel_err(p.simulate(x), j.simulate(x)) < 1e-5


def test_rhs_matches(pair):
    j, p, _, _, _ = pair
    rng = np.random.default_rng(3)
    y = rand64c(p.nc * p.n_samples, rng=rng)
    ys = j.plan.sort_samples(y, ncoil=j.nc)[:, None].astype(np.complex64)
    rr, ri = j._rhs_fn(j._A_d, j._wd, ys)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    assert rel_err(p.rhs(y), ref) < 1e-5


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
def test_image_and_resids_match(pair):
    j, p, _, _, cfg = pair
    y = j.simulate(phantom(cfg["img"]))
    xj, rj = j(y, return_resids=True)
    xp, rp = p(y, return_resids=True)
    assert xp.shape == cfg["img"] and xp.dtype == np.complex64
    assert rel_err(xp, xj) < 1e-4
    assert rel_err(rp, rj) < 1e-4
    assert p.last_iters == cfg["kw"]["iters"]
    assert rel_err(xp, phantom(cfg["img"])) < 0.2


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
def test_from_arrays_matches_reference(pair):
    j, _, traj, maps, cfg = pair
    kw = cfg["kw"]
    gplan = j.A.left.child.plan      # KronI(GridDFT) . VStack(Diag)
    Tf = j_toeplitz_kernel(traj, cfg["img"], oversamp=kw["oversamp"],
                           width=kw["width"], weights=j._w_user, warn=False)
    state = state_from_reference_arrays(
        Tf=Tf, maps=maps, w_sorted=j._w_sorted, perm=j.plan.perm,
        deapod=j.plan.deapod, tid=np.asarray(gplan.tid),
        wfac=[np.asarray(w) for w in gplan.wfac],
        grid_shape=gplan.grid_shape, tile=gplan.tile, ext=gplan.ext,
        nt=gplan.nt, pad_lo=gplan.pad_lo, width=gplan.width,
        lamda=j.lamda, iters=j.iters)
    p = SenseRecon.from_arrays(state, device="cpu")
    y = j.simulate(phantom(cfg["img"]))
    assert rel_err(p(y), j(y)) < 1e-4


def test_user_order_invariance(pair):
    _, p, traj, maps, cfg = pair
    rng = np.random.default_rng(5)
    shuffle = rng.permutation(len(traj))
    p2 = SenseRecon(traj[shuffle], maps, device="cpu", **cfg["kw"])
    y = p.simulate(phantom(cfg["img"])).reshape(p.nc, -1)
    x_a = p(y.reshape(-1))
    x_b = p2(y[:, shuffle].reshape(-1))
    assert rel_err(x_b, x_a) < 1e-3


def test_stream_matches_calls(pair):
    _, p, _, _, _ = pair
    rng = np.random.default_rng(6)
    ys = [rand64c(p.nc * p.n_samples, rng=rng) for _ in range(3)]
    out = list(p.stream(ys))
    assert len(out) == 3
    for y, x in zip(ys, out):
        assert isinstance(x, np.ndarray)
        assert rel_err(x, p(y)) < 1e-6
    dev = list(p.stream(ys[:1], output="device"))
    assert isinstance(dev[0], torch.Tensor)


def copies():
    return host_copy.pinned_copies, host_copy.pageable_copies


@pytest.fixture
def pinned_allocs(monkeypatch):
    """Every ``torch.empty(..., pin_memory=True)`` made while the test runs."""
    made, empty = [], torch.empty

    def counted(*a, **k):
        if k.get("pin_memory"):
            made.append(a)
        return empty(*a, **k)

    monkeypatch.setattr(torch, "empty", counted)
    return made


def test_host_output_on_the_cpu_is_the_solve_tensor(pair, pinned_allocs,
                                                    monkeypatch):
    """On a CPU pipeline the image leaves through the pageable path: one
    count there, none pinned, no pinned allocation, and the array is the
    solve's own tensor, value for value and memory for memory."""
    _, p, _, _, cfg = pair
    y = rand64c(p.nc * p.n_samples, rng=np.random.default_rng(8))
    seen, solve = [], p.solve

    def keep(rhs):
        out = solve(rhs)
        seen.append(out[0])
        return out

    monkeypatch.setattr(p, "solve", keep)
    pinned, pageable = copies()
    x = p(y)
    assert copies() == (pinned, pageable + 1)
    assert pinned_allocs == []
    assert isinstance(x, np.ndarray)
    assert x.shape == cfg["img"] and x.dtype == np.complex64
    own = seen[0].numpy()
    np.testing.assert_array_equal(x.ravel(), own)
    assert np.shares_memory(x, own)
    x, r = p(y, return_resids=True)     # the resids do not count
    assert copies() == (pinned, pageable + 2)
    assert p(y, output="device") is not None
    assert copies() == (pinned, pageable + 2)


def test_simulate_and_stream_on_the_cpu_count_pageable(pair, pinned_allocs):
    _, p, _, _, cfg = pair
    rng = np.random.default_rng(9)
    ys = [rand64c(p.nc * p.n_samples, rng=rng) for _ in range(3)]
    pinned, pageable = copies()
    k = p.simulate(phantom(cfg["img"]))
    assert isinstance(k, np.ndarray) and k.shape == (p.nc * p.n_samples,)
    assert copies() == (pinned, pageable + 1)
    out = list(p.stream(ys))
    assert copies() == (pinned, pageable + 4)
    list(p.stream(ys, output="device"))
    assert copies() == (pinned, pageable + 4)
    assert pinned_allocs == []
    for y, x in zip(ys, out):
        assert rel_err(x, p(y)) < 1e-6


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
def test_jacobi_tol_and_errors(pair):
    j, _, traj, maps, cfg = pair
    kw = dict(cfg["kw"], iters=40)
    jj = JRecon(traj, maps, precond="jacobi", tol=1e-3, **kw)
    pp = SenseRecon(traj, maps, precond="jacobi", tol=1e-3, device="cpu",
                    **kw)
    y = j.simulate(phantom(cfg["img"]))
    assert rel_err(pp(y), jj(y)) < 1e-4
    assert pp.last_iters == jj.last_iters < 40
    with pytest.raises(ValueError):
        pp(np.zeros(17, np.complex64))
    # dcf="pipe_menon" builds (it raised before it was ported) and matches
    jm = JRecon(traj, maps, dcf="pipe_menon", **kw)
    pm = SenseRecon(traj, maps, dcf="pipe_menon", device="cpu", **kw)
    assert rel_err(pm(y), jm(y)) < 1e-4


def test_default_device_is_cuda():
    """SenseRecon runs on the card unless the caller asks for the CPU, as
    the reference runs on its accelerator: with no card, building it with
    no ``device`` raises where torch raises, and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default builds on it")
    import inspect

    for fn in (SenseRecon.__init__, SenseRecon.from_arrays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    traj = radial_traj(16, 16)
    maps = smooth_maps((8, 8), [(0.3, 0.3), (0.7, 0.7)])
    with pytest.raises((AssertionError, RuntimeError)):
        SenseRecon(traj, maps, oversamp=2.0, width=4, iters=2)
