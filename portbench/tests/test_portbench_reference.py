"""The benchmark's plain references held to the JAX package (the
reference implementation the port was written from), at small sizes on
the CPU. Only this test imports ``indigo_tpu``; nothing ``run.py`` loads
does."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from portbench.lib import spec  # noqa: E402
from portbench.reference import common  # noqa: E402

SMALL = {
    "kooshball3d-256c8": {"image": [24, 24, 24], "coils": 3, "spokes": 384,
                          "readout": 24, "coil_chunk": 3},
    "radial2d-256c8": {"image": [32, 32], "spokes": 48, "readout": 64},
}


def small(config, seed=11):
    cfg = dict(spec.config(config), **SMALL[config])
    system = spec.module("configs", config).System(cfg, seed, "cpu")
    return cfg, system, system.make_pool(2)


def rel(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def koosh():
    cfg, system, pool = small("kooshball3d-256c8")
    ref = spec.module("reference", "kooshball3d-256c8").Reference(
        cfg, system.traj, system.maps, "float64", "cpu")
    return cfg, system, pool, ref


def test_3d_forward_model_matches_the_jax_package(koosh):
    from indigo_tpu.models.sense import sense_nufft_op
    cfg, system, _, ref = koosh
    A, plan = sense_nufft_op(system.traj, system.maps, oversamp=cfg[
        "oversamp"], width=cfg["width"])
    x = common.tf32_round(torch.randn(tuple(cfg["image"]) + (2,),
                                      dtype=torch.float32))
    x = torch.view_as_complex(x).numpy()
    y_jax = plan.unsort_samples(np.asarray(A * x.ravel()),
                                ncoil=cfg["coils"])
    y_ref = ref.A.forward(torch.from_numpy(x)).reshape(-1).numpy()
    assert rel(y_jax, y_ref) < 1e-5


def test_3d_spectrum_and_lamda_match_the_jax_package(koosh):
    from indigo_tpu.models.recon import SenseRecon
    from indigo_tpu.toeplitz import toeplitz_kernel
    cfg, system, _, ref = koosh
    Tf = toeplitz_kernel(system.traj, tuple(cfg["image"]),
                         oversamp=cfg["oversamp"], width=cfg["width"],
                         weights=ref.w.numpy().astype(np.float32))
    assert rel(np.asarray(Tf), ref.Tf.numpy()) < 1e-5
    recon = SenseRecon(system.traj, system.maps, oversamp=cfg["oversamp"],
                       width=cfg["width"], iters=cfg["iters"])
    assert abs(recon.lamda - ref.lamda) <= 1e-5 * ref.lamda


def test_3d_reconstruction_matches_the_jax_package(koosh):
    from indigo_tpu.models.recon import SenseRecon
    cfg, system, pool, ref = koosh
    recon = SenseRecon(system.traj, system.maps, oversamp=cfg["oversamp"],
                       width=cfg["width"], iters=cfg["iters"],
                       coil_chunk=cfg["coil_chunk"])
    nums = ref.numbers(pool[0], ref.answer(pool[0]),
                       np.asarray(recon(pool[0])))
    # the JAX package's float32 image lies as close to the float64
    # reference as the port's does at this size (< 2e-5)
    assert nums["img_rel_l2"] < 5e-5, nums


def test_2d_recipe_matches_the_jax_package():
    import indigo_tpu as it
    from indigo_tpu.models.sense import sense_nufft_op
    cfg, system, pool = small("radial2d-256c8")
    ref = spec.module("reference", "radial2d-256c8").Reference(
        cfg, system.traj, system.maps, "float64", "cpu")
    A, plan = sense_nufft_op(system.traj, system.maps,
                             oversamp=cfg["oversamp"], width=cfg["width"],
                             interp="sparse")
    y = pool[0]
    x0 = np.zeros(tuple(cfg["image"]), np.complex64)
    x0[10, 20] = 1.0
    fwd = plan.unsort_samples(np.asarray(A * x0.ravel()), ncoil=cfg["coils"])
    assert rel(fwd, ref.A.forward(torch.from_numpy(x0)).reshape(-1)) < 1e-5
    b_jax = np.asarray(A.H * plan.sort_samples(y, ncoil=cfg["coils"]))
    b = ref.answer(y)
    assert rel(b_jax, b.numpy()) < 1e-5
    x, _ = it.cg(A.H * A, b_jax, lamda=cfg["lamda"], tol=cfg["tol"],
                 maxiter=cfg["maxiter"])
    limit = spec.limits("radial2d-256c8.slices")["normal_residual"]["limit"]
    nums = ref.numbers(y, b, np.asarray(x).reshape(cfg["image"]))
    assert nums["normal_residual"] < limit, nums
