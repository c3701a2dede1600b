"""The benchmark's operator-tree configuration (``toeplitz3d-256c8``: the
recipe of ``examples/multicoil_3d.py``, Pipe-Menon DCF and ``solvers.cg`` on
``coils.H * KronI(nc, ToeplitzNormal) * coils``) run through its own
``System`` at a short 32^3 kooshball with 4 coils on the CPU, against its
plain float64 reference (``portbench/reference/toeplitz3d-256c8.py``).

The bar is 1e-4 on the image's relative l2 gap, the tree-CG bar of
``test_torch_toeplitz_normal.py``: the port computes in float32 and the
reference in float64, and ten CG steps carry the float32 rounding of the
DCF, the spectrum, the rhs and every apply (about 1e-5 here). A path with
half the coils dropped from the normal operator, or with CG's steps cut,
misses the bar by orders of magnitude.
"""
import numpy as np
import pytest

from portbench.lib import spec

CONFIG = "toeplitz3d-256c8"
SMALL = {"image": [32, 32, 32], "coils": 4, "spokes": 512, "readout": 32}
BAR = 1e-4


@pytest.fixture(scope="module")
def problem():
    cfg = dict(spec.config(CONFIG), **SMALL)
    system = spec.module("configs", CONFIG).System(cfg, 4100000009, "cpu")
    pool = system.make_pool(2)
    ref = spec.module("reference", CONFIG).Reference(
        cfg, system.traj, system.maps, "float64", "cpu")
    return cfg, system, pool, ref, [ref.answer(y) for y in pool]


def served(problem):
    cfg, system, pool, ref, answers = problem
    system.build()
    out = [system.serve(y) for y in pool]
    return [ref.numbers(y, a, x) for y, a, x in zip(pool, answers, out)]


def test_the_tree_recipe_matches_its_plain_reference(problem):
    cfg, system, _, ref, _ = problem
    nums = served(problem)
    assert all(n["img_rel_l2"] < BAR for n in nums), nums
    assert system.lamda == pytest.approx(ref.lamda, rel=1e-5)
    # the program's density compensation is the reference's
    from indigo_tpu_torch.noncart import pipe_menon_dcf
    grid = tuple(int(2 * round(n * cfg["oversamp"] / 2))
                 for n in cfg["image"])
    w = pipe_menon_dcf(system.traj, grid, width=cfg["width"],
                       iters=cfg["dcf_iters"], device="cpu")
    assert np.linalg.norm(w - ref.w.numpy()) < 1e-5 * np.linalg.norm(w)
    assert system.counters() == dict.fromkeys(system.counters(), 0)


def break_tree(monkeypatch, fault):
    import indigo_tpu_torch
    from indigo_tpu_torch import toeplitz
    if fault == "coils_dropped":
        normal = toeplitz.sense_normal_toeplitz

        def half(Tf, maps, device=None):
            return 2 * normal(Tf, maps[: len(maps) // 2], device=device)
        monkeypatch.setattr(toeplitz, "sense_normal_toeplitz", half)
    elif fault == "steps_cut":
        cg = indigo_tpu_torch.cg
        monkeypatch.setattr(indigo_tpu_torch, "cg", lambda *a, **k: cg(
            *a, **dict(k, maxiter=k["maxiter"] // 2)))


@pytest.mark.parametrize("fault", ["coils_dropped", "steps_cut"])
def test_a_broken_tree_path_misses_the_bar(problem, fault, monkeypatch):
    break_tree(monkeypatch, fault)
    nums = served(problem)
    assert all(n["img_rel_l2"] > 100 * BAR for n in nums), nums
