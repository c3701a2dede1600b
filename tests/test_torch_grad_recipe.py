"""The benchmark's training configuration (``kooshball3d-256c8-grad``:
``SenseRecon`` differentiated end to end as an unrolled network's
data-consistency block, L = 1/2 ||x - x_t||^2 and its gradient in the
k-space y) run through its own ``System`` at a short 32^3 kooshball with 4
coils on the CPU, against its plain float64 reference
(``portbench/reference/kooshball3d-256c8-grad.py``); the reference itself
against a float64 central difference, against ``jax.grad`` of the JAX
package's ``SenseRecon`` pieces, and its Hermitian normal apply against
autograd through ``normal`` unwrapped.

Bars, each with its reason:
  * IMG_BAR 1e-4 on the image's relative l2 gap: the tree recipe's bar
    (``test_torch_tree_recipe.py``); the port computes in float32 and the
    reference in float64, and ten CG steps carry the float32 rounding of
    the spectrum, the rhs and every apply (about 1e-5 here).
  * GRAD_BAR 5e-4 on the gradient's: the gradient runs the ten steps
    twice, forward and on the cotangents, and the rhs's reverse on top,
    all in float32; CG's step sizes depend on y, so their rounding enters
    the gradient through their derivatives too (about 3e-5 here).
  * FD_TOL 1e-6: the reference against its own central difference in
    float64, where the second-order term at step 1e-4 of |y| is ~1e-8.
  * JAX_TOL 1e-4: the JAX package computes in float32 (the solve bar of
    ``test_torch_grad.py``).
  * HERM_TOL 1e-12: float64 rounding of one normal apply.
A path with one coil chunk's backward normal apply left out, or with the
rhs's backward giving zeros, misses GRAD_BAR by orders of magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indigo_tpu.models import SenseRecon as JRecon
from indigo_tpu.parallel.recon import batched_cg as j_batched_cg
from indigo_tpu.parallel.recon import sense_normal_batched as j_batched
from indigo_tpu_torch.ops import dft_cuda
from indigo_tpu_torch.utils import rel_err
from portbench.lib import spec

CONFIG = "kooshball3d-256c8-grad"
SMALL = {"image": [32, 32, 32], "coils": 4, "spokes": 512, "readout": 32,
         "coil_chunk": 2}
TINY = {"image": [16, 16, 16], "coils": 2, "spokes": 128, "readout": 16}
IMG_BAR, GRAD_BAR = 1e-4, 5e-4
FD_TOL, JAX_TOL, HERM_TOL = 1e-6, 1e-4, 1e-12
SEED = 4100000023


def build(size):
    cfg = dict(spec.config(CONFIG), **size)
    system = spec.module("configs", CONFIG).System(cfg, SEED, "cpu")
    pool = system.make_pool(2)
    ref = spec.module("reference", CONFIG).Reference(
        cfg, system.traj, system.maps, "float64", "cpu")
    return cfg, system, pool, ref


@pytest.fixture(scope="module")
def problem():
    cfg, system, pool, ref = build(SMALL)
    return cfg, system, pool, ref, [ref.answer(y) for y in pool]


@pytest.fixture(scope="module")
def tiny():
    return build(TINY)


def served(problem):
    cfg, system, pool, ref, answers = problem
    system.build()
    out = [system.serve(y) for y in pool]
    return [ref.numbers(y, a, x) for y, a, x in zip(pool, answers, out)]


def test_the_grad_recipe_matches_its_plain_reference(problem):
    cfg, system, pool, ref, _ = problem
    nums = served(problem)
    assert all(n["img_rel_l2"] < IMG_BAR for n in nums), nums
    assert all(n["grad_rel_l2"] < GRAD_BAR for n in nums), nums
    assert system.recon.lamda == pytest.approx(ref.lamda, rel=1e-5)
    out = system.serve(pool[0])
    n = int(np.prod(cfg["image"]))
    assert out.shape == (n + pool[0].size,) and out.dtype == np.complex64


def through_the_function(monkeypatch, skip_first_chunk=False):
    """The plain normal op's calls routed through ``_SenseNormalFn`` (as
    K1's are on the card), the first coil chunk's backward giving zeros
    with ``skip_first_chunk``."""
    plain = dft_cuda.sense_normal_reference

    def launch(Tf, v, maps, events):
        return plain(Tf, maps, v)

    class Skipped(dft_cuda._SenseNormalFn):
        @staticmethod
        def backward(ctx, g):
            out = list(dft_cuda._SenseNormalFn.backward(ctx, g))
            out[3] = torch.zeros_like(out[3])
            return tuple(out)

    def routed(Tf, maps, v):
        first = maps.storage_offset() == 0
        fn = (Skipped if skip_first_chunk and first
              else dft_cuda._SenseNormalFn)
        return fn.apply(launch, Tf, maps, v)
    monkeypatch.setattr(dft_cuda, "sense_normal_reference", routed)


def break_grad(monkeypatch, fault):
    from indigo_tpu_torch.models.recon import SenseRecon
    if fault == "k1_backward_chunk_skipped":
        through_the_function(monkeypatch, skip_first_chunk=True)
    elif fault == "rhs_backward_skipped":
        rhs = SenseRecon.rhs

        def skipped(self, y):
            return rhs(self, y.detach()) + 0 * rhs(self, y)
        monkeypatch.setattr(SenseRecon, "rhs", skipped)


def test_the_routed_function_keeps_the_bars(problem, monkeypatch):
    through_the_function(monkeypatch)
    before = dft_cuda.sense_normal_cuda.backward_calls
    nums = served(problem)
    assert all(n["grad_rel_l2"] < GRAD_BAR for n in nums), nums
    # 10 steps x 2 coil chunks, one backward launch each, per request
    assert dft_cuda.sense_normal_cuda.backward_calls - before == 2 * 20


@pytest.mark.parametrize("fault", ["k1_backward_chunk_skipped",
                                   "rhs_backward_skipped"])
def test_a_broken_grad_path_misses_the_bar(problem, fault, monkeypatch):
    break_grad(monkeypatch, fault)
    nums = served(problem)
    assert all(n["img_rel_l2"] < IMG_BAR for n in nums), nums
    assert all(n["grad_rel_l2"] > 100 * GRAD_BAR for n in nums), nums


def split(y, answer):
    m = np.asarray(y).size
    return answer[:-m], answer[-m:]


def test_the_reference_gradient_matches_a_central_difference(tiny):
    cfg, system, pool, ref = tiny
    y = torch.from_numpy(pool[0]).to(torch.complex128)
    _, grad = split(y, ref.answer(y.numpy()))
    d = torch.from_numpy(spec.module("configs", "kooshball3d-256c8").System(
        cfg, SEED + 1, "cpu").make_pool(1)[0]).to(torch.complex128)
    xt = ref.xt.reshape(-1)

    def loss(yy):
        x, _ = split(yy, ref.answer(yy.numpy()))
        return 0.5 * float(torch.sum((x - xt).abs() ** 2))

    eps = 1e-4 * float(torch.linalg.vector_norm(y)
                       / torch.linalg.vector_norm(d))
    fd = (loss(y + eps * d) - loss(y - eps * d)) / (2 * eps)
    an = float((grad.conj() * d).real.sum())
    assert abs(fd - an) < FD_TOL * abs(an), (fd, an)


def test_the_reference_gradient_matches_jax_grad(tiny):
    """The JAX package's ``SenseRecon`` pieces (its rhs and CG bodies, as
    ``test_torch_grad.py`` composes them) under ``jax.grad``: torch's
    gradient of a real loss is the conjugate of JAX's."""
    cfg, system, pool, ref = tiny
    j = JRecon(system.traj, system.maps, oversamp=cfg["oversamp"],
               width=cfg["width"], lamda=cfg["lamda"], iters=cfg["iters"],
               dcf=cfg["dcf"])
    assert j.lamda == pytest.approx(ref.lamda, rel=1e-5)
    nc, n = cfg["coils"], int(np.prod(cfg["image"]))
    perm = np.asarray(j.plan.perm)
    jm = jnp.asarray(system.maps)
    xt = jnp.asarray(ref.xt.reshape(-1).numpy().astype(np.complex64))

    def loss(yy):
        ys = yy.reshape(nc, -1)[:, perm].reshape(-1, 1)
        r = j.A.apply(j._wd[:, None] * ys, adjoint=True).reshape(1, n)
        x = j_batched_cg(lambda v: j_batched(j._Tf, jm, v, layout="block"),
                         r, lamda=j.lamda, iters=j.iters)[0][0]
        return 0.5 * jnp.sum(jnp.abs(x - xt) ** 2)

    g_jax = np.conj(np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(pool[0]))))
    _, grad = split(pool[0], ref.answer(pool[0]))
    assert rel_err(torch.from_numpy(g_jax), grad) < JAX_TOL


def test_the_reference_normal_is_hermitian_and_its_function_exact(tiny):
    cfg, system, pool, ref = tiny
    gen = torch.Generator().manual_seed(3)
    u, v = (torch.randn(tuple(cfg["image"]), dtype=torch.complex128,
                        generator=gen) for _ in range(2))
    lhs = torch.vdot(u.reshape(-1), ref.normal(v).reshape(-1))
    rhs = torch.vdot(ref.normal(u).reshape(-1), v.reshape(-1))
    assert abs(lhs - rhs) < HERM_TOL * abs(lhs)
    wrapped = ref.answer(pool[0])
    unwrapped = ref.answer(pool[0], normal=ref.normal)
    assert rel_err(wrapped, unwrapped) < HERM_TOL
