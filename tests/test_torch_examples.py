"""The five example scripts of the port on the CPU at small sizes (their own
asserts run inside ``main``), their problem set-up array-equal to the
reference examples' (``examples/*.py``, imported by path), and their
default device the card."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from indigo_tpu_torch.examples import (
    cartesian_sense_2d, cs_wavelet_fista, multicoil_3d, radial_sense_2d,
    serving_pipeline)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["cartesian_sense_2d", "radial_sense_2d", "multicoil_3d",
         "cs_wavelet_fista", "serving_pipeline"]
PORT = {"cartesian_sense_2d": cartesian_sense_2d,
        "radial_sense_2d": radial_sense_2d, "multicoil_3d": multicoil_3d,
        "cs_wavelet_fista": cs_wavelet_fista,
        "serving_pipeline": serving_pipeline}
SMALL = {"cartesian_sense_2d": dict(n=32),
         "radial_sense_2d": dict(n=32, nc=4),
         "multicoil_3d": dict(n=16),
         "cs_wavelet_fista": dict(n=32),
         "serving_pipeline": dict(n=16)}


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name):
    out = PORT[name].main(device="cpu", **SMALL[name])
    assert out["device"] == "cpu"
    for k, v in out.items():
        if isinstance(v, float):
            assert np.isfinite(v), (k, v)


def _maps_3d(n, nc, rng):
    """The maps and volume the reference's 3D examples build inline
    (``examples/multicoil_3d.py:47-53``, ``serving_pipeline.py:51-57``)."""
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    maps = np.asarray([
        (0.4 + np.exp(-(((xx - a) ** 2 + (yy - b) ** 2 + (zz - c) ** 2) * 3)))
        * np.exp(1j * 2 * np.pi * (a * xx + b * yy))
        for a, b, c in rng.random((nc, 3))], dtype=np.complex64)
    x = np.exp(-(((xx - .5) ** 2 + (yy - .5) ** 2 + (zz - .5) ** 2) * 9)
               ).astype(np.complex64)
    return maps, x


def _equal(a, b):
    if hasattr(a, "toarray"):
        assert (a != b).nnz == 0 and a.shape == b.shape
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("name", NAMES)
def test_problem_setup_equals_the_reference(name):
    ref, port = _reference(name), PORT[name]
    if name == "cartesian_sense_2d":
        for got, want in zip(port.make_problem(24, rng=0),
                             ref.make_problem(24, rng=0)):
            _equal(got, want)
    elif name == "radial_sense_2d":
        _equal(port.radial_traj(36, 48), ref.radial_traj(36, 48))
        _equal(port.smooth_maps(3, (24, 20), np.random.default_rng(0)),
               ref.smooth_maps(3, (24, 20), np.random.default_rng(0)))
        _equal(port.phantom((24, 20)), ref.phantom((24, 20)))
    elif name == "cs_wavelet_fista":
        _equal(port.vardens_mask((32, 32), accel=3, rng=0),
               ref.vardens_mask((32, 32), accel=3, rng=0))
        _equal(port.phantom(32), ref.phantom(32))
        yy, xx = np.mgrid[0:32, 0:32] / 32       # cs_wavelet_fista.py:53-58
        maps = np.asarray([
            (0.5 + np.exp(-(((xx - a) ** 2 + (yy - b) ** 2) * 3)))
            * np.exp(1j * 2 * np.pi * (a * xx + b * yy))
            for a, b in [(0.3, 0.3), (0.3, 0.7), (0.7, 0.3), (0.7, 0.7)][:3]],
            dtype=np.complex64)
        _equal(port.coil_maps(32, 3), maps)
    else:
        n, nc = 12, 3
        rng = np.random.default_rng(0)
        if name == "multicoil_3d":
            traj, maps, x = port.make_problem(n, nc, 64,
                                              np.random.default_rng(0))
            want_traj = ref.kooshball(64, n, rng)
        else:
            traj, maps, x = port.make_problem(n, nc,
                                              np.random.default_rng(0))
            want_traj = ref.kooshball(16 * n, n, rng)
        want_maps, want_x = _maps_3d(n, nc, rng)
        _equal(traj, want_traj)
        _equal(maps, want_maps)
        _equal(x, want_x.ravel() if x.ndim == 1 else want_x)


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default run is phase 10 of "
                    "chip_smoke.py")
    with pytest.raises((AssertionError, RuntimeError)):
        PORT[name].main(**SMALL[name])
