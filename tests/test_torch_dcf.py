"""Pipe-Menon density compensation: the port vs the reference.

The host fixed point is a copy of the reference's (scipy CSR, float64
accumulation): held to 1e-5. The device fixed point (KB gather and
``index_add_`` adjoint, float32) runs here on CPU tensors and is held to the
host one at 1e-4, the reference's own bar between its two paths
(tests/test_aux.py). ``SenseRecon(dcf="pipe_menon")`` is held to the
reference pipeline's image at 1e-4, like the other SenseRecon checks.
The comparisons with the reference run on each gridding builder in both
packages (tests/test_torch_native.py).
"""
import numpy as np
import pytest

from indigo_tpu import noncart as j_noncart
from indigo_tpu.models import SenseRecon as JRecon
from indigo_tpu_torch import noncart
from indigo_tpu_torch.models import SenseRecon
from indigo_tpu_torch.utils import rand64c, rel_err

from test_torch_native import BUILDERS, builder  # noqa: F401


def _radial_2d():
    ang = np.pi * np.arange(16) / 16
    r = (np.arange(32) - 16) / 32
    return np.stack([np.outer(np.cos(ang), r).ravel(),
                     np.outer(np.sin(ang), r).ravel()], axis=1)


def _cases(rng):
    return {"radial2d": (_radial_2d(), (48, 48), 25),
            "random3d": (rng.random((250, 3)) - 0.5, (16, 16, 20), 12)}


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
@pytest.mark.parametrize("case", ["radial2d", "random3d"])
def test_host_matches_reference(rng, case, builder):
    traj, grid, iters = _cases(rng)[case]
    ref = j_noncart.pipe_menon_dcf(traj, grid, width=4, iters=iters,
                                   impl="host")
    out = noncart.pipe_menon_dcf(traj, grid, width=4, iters=iters,
                                 impl="host")
    assert out.dtype == np.float32 and out.shape == (len(traj),)
    assert rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("case", ["radial2d", "random3d"])
def test_device_on_cpu_tensors_matches_host(rng, case):
    traj, grid, iters = _cases(rng)[case]
    host = noncart.pipe_menon_dcf(traj, grid, width=4, iters=iters,
                                  impl="host")
    dev = noncart.pipe_menon_dcf(traj, grid, width=4, iters=iters,
                                 impl="device", device="cpu")
    assert dev.dtype == np.float32 and dev.max() == 1.0
    assert rel_err(dev, host) < 1e-4


def test_radial_weights_ramp_and_auto_is_host_off_cuda():
    traj = _radial_2d()
    w = noncart.pipe_menon_dcf(traj, (48, 48), width=4, iters=25, device="cpu")
    np.testing.assert_array_equal(
        w, noncart.pipe_menon_dcf(traj, (48, 48), width=4, iters=25,
                                  impl="host"))
    w = w.reshape(16, 32)
    assert (w[:, 28] > 2 * w[:, 16]).all()   # |k| = 0.375 vs DC
    with pytest.raises(ValueError):
        noncart.pipe_menon_dcf(traj, (48, 48), impl="gpu", device="cpu")


def _kooshball(nspokes, nread, seed=0):
    rng = np.random.default_rng(seed)
    u, v = rng.random(nspokes), rng.random(nspokes)
    th, ph = np.arccos(2 * u - 1), 2 * np.pi * v
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], axis=1)
    r = (np.arange(nread) - nread // 2) / nread
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)


@pytest.mark.parametrize("builder", BUILDERS, indirect=True)
@pytest.mark.parametrize("dim", [2, 3])
def test_sense_recon_pipe_menon_matches_reference(rng, dim, builder):
    if dim == 2:
        traj, img = _radial_2d() * 0.9, (16, 16)
    else:
        traj, img = _kooshball(96, 16), (12, 12, 12)
    maps = (0.6 + 0.2 * rand64c(2, *img, rng=rng)).astype(np.complex64)
    kw = dict(oversamp=2.0, width=4, iters=10, dcf="pipe_menon")
    j = JRecon(traj, maps, **kw)
    p = SenseRecon(traj, maps, device="cpu", **kw)
    assert rel_err(p.wd.numpy(), j._w_sorted) < 1e-5
    y = rand64c(2 * len(traj), rng=rng)
    assert rel_err(p(y), j(y)) < 1e-4
