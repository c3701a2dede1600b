"""Toeplitz spectrum: the port's host build vs the reference's host build,
and the port's torch (device) build run on CPU tensors vs its host build.
Tolerance 1e-5 (f32 rounding; the torch build sums in another order)."""
import numpy as np
import pytest

from indigo_tpu.toeplitz import toeplitz_kernel as j_kernel
from indigo_tpu_torch.toeplitz import toeplitz_kernel
from indigo_tpu_torch.utils import rel_err

from test_torch_native import builder  # noqa: F401


@pytest.mark.parametrize("img,oversamp,weighted", [
    ((8, 8, 8), 1.25, True), ((12, 12), 2.0, False)])
def test_host_matches_reference(rng, img, oversamp, weighted, builder):
    traj = rng.uniform(-0.5, 0.5, size=(400, len(img)))
    w = rng.uniform(0.2, 1.0, 400).astype(np.float32) if weighted else None
    ref, rinfo = j_kernel(traj, img, oversamp=oversamp, width=4, weights=w,
                          return_info=True, warn=False, impl="host")
    out, info = toeplitz_kernel(traj, img, oversamp=oversamp, width=4,
                                weights=w, return_info=True, warn=False,
                                impl="host", device="cpu")
    assert out.shape == ref.shape and out.dtype == np.float32
    assert rel_err(out, ref) < 1e-5
    assert abs(info["max"] - rinfo["max"]) <= 1e-5 * rinfo["max"]


@pytest.mark.parametrize("img,oversamp", [((8, 8, 8), 1.25),
                                          ((12, 12), 2.0)])
def test_torch_build_matches_host(rng, img, oversamp):
    traj = rng.uniform(-0.5, 0.5, size=(400, len(img)))
    w = rng.uniform(0.2, 1.0, 400).astype(np.float32)
    host = toeplitz_kernel(traj, img, oversamp=oversamp, width=4, weights=w,
                           warn=False, impl="host", device="cpu")
    dev = toeplitz_kernel(traj, img, oversamp=oversamp, width=4, weights=w,
                          warn=False, impl="device", device="cpu")
    assert rel_err(dev, host) < 1e-5


def test_auto_is_host_off_cuda(rng):
    traj = rng.uniform(-0.5, 0.5, size=(50, 2))
    a = toeplitz_kernel(traj, (8, 8), width=4, warn=False, device="cpu")
    b = toeplitz_kernel(traj, (8, 8), width=4, warn=False, impl="host")
    np.testing.assert_array_equal(a, b)
