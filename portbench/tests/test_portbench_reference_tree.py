"""The plain reference of ``toeplitz3d-256c8`` held to the JAX package's
operator-tree recipe (``pipe_menon_dcf``, ``toeplitz_kernel`` with those
weights, ``sense_normal_toeplitz`` and ``cg``) at a small size on the CPU,
as ``test_portbench_reference.py`` holds the kooshball reference. Only
these tests import ``indigo_tpu``; nothing ``run.py`` loads does."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from portbench.lib import spec  # noqa: E402

CONFIG = "toeplitz3d-256c8"
SMALL = {"image": [24, 24, 24], "coils": 3, "spokes": 384, "readout": 24}


def rel(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def recipe():
    """The JAX package's recipe on the configuration's inputs, and the
    reference."""
    import indigo_tpu as it
    from indigo_tpu.models.sense import sense_nufft_op
    from indigo_tpu.noncart import pipe_menon_dcf
    from indigo_tpu.toeplitz import sense_normal_toeplitz, toeplitz_kernel
    cfg = dict(spec.config(CONFIG), **SMALL)
    system = spec.module("configs", CONFIG).System(cfg, 11, "cpu")
    y = system.make_pool(1)[0]
    ref = spec.module("reference", CONFIG).Reference(
        cfg, system.traj, system.maps, "float64", "cpu")
    os_, width, nc = cfg["oversamp"], cfg["width"], cfg["coils"]
    grid = tuple(int(2 * round(n * os_ / 2)) for n in cfg["image"])
    w = np.asarray(pipe_menon_dcf(system.traj, grid, width=width,
                                  iters=cfg["dcf_iters"]))
    Tf, info = toeplitz_kernel(system.traj, tuple(cfg["image"]),
                               oversamp=os_, width=width, weights=w,
                               return_info=True, warn=False)
    A, plan = sense_nufft_op(system.traj, system.maps, oversamp=os_,
                             width=width)
    N = sense_normal_toeplitz(Tf, system.maps)
    b = A.H * (np.tile(w[plan.perm], nc) * plan.sort_samples(y, ncoil=nc))
    lamda = max(1e-3, 10.0 ** (1 - width)) * info["max"]
    x, _ = it.cg(N, b, lamda=lamda, tol=cfg["tol"], maxiter=cfg["iters"])
    return dict(w=w, Tf=np.asarray(Tf), lamda=lamda, b=np.asarray(b),
                x=np.asarray(x)), ref, y


def test_the_density_compensation_matches_the_jax_package(recipe):
    got, ref, _ = recipe
    assert rel(got["w"], ref.w.numpy()) < 1e-5


def test_the_spectrum_and_lamda_match_the_jax_package(recipe):
    got, ref, _ = recipe
    assert rel(got["Tf"], ref.Tf.numpy()) < 1e-5
    assert got["lamda"] == pytest.approx(ref.lamda, rel=1e-5)


def test_the_reconstruction_matches_the_jax_package(recipe):
    got, ref, y = recipe
    assert rel(got["b"], ref.rhs(y).numpy()) < 1e-5
    nums = ref.numbers(y, ref.answer(y), got["x"].reshape(ref.A.img))
    # the JAX package's float32 image lies as close to the float64
    # reference as the port's does at this size (~1e-5)
    assert nums["img_rel_l2"] < 5e-5, nums
