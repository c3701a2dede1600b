"""``analyses`` (Memusage, memusage_report, apply_cost) and the rest of
``utils`` (randM, Timer) against the reference.

A reference tree and its conversion (``convert.operator_from_reference``)
have the same nodes, names and shapes, so the reports have the same rows.
The payload column counts the arrays each package holds: equal where both
hold the same arrays (Diag, DenseMatrix, the FFT leaves, the combinators;
Scale keeps its factor as an array there and as a number here), different
where the port stores another form (KB patches for a tile plan,
row-form tiles for an SpMatrix, int64 rows for a Mask). ``apply_cost`` is
``Operator.cost`` in both; the flop counts agree wherever the formula is the
reference's (all leaves but the fused gridding leaf).
"""
import time

import numpy as np
import pytest

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu import analyses as ja
from indigo_tpu.utils import Timer as JTimer
from indigo_tpu.utils import randM as j_randM
from indigo_tpu_torch import analyses as ta
from indigo_tpu_torch import convert
from indigo_tpu_torch.utils import Timer, rand64c, randM


def _trees(rng):
    from indigo_tpu.models import cartesian_sense_op, sense_nufft_op

    n = 16
    traj = rng.random((100, 2)) - 0.5
    maps = rand64c(2, n, n, rng=rng)
    dense = (jit_.KronI(2, jit_.DenseMatrix(rand64c(6, 30, rng=rng))
                        * jit_.UnscaledFFT((5, 6)))
             * jit_.VStack([jit_.Diag(rand64c(30, rng=rng))
                            for _ in range(2)])).H
    return {
        "dense": dense,
        "cartesian": cartesian_sense_op(rng.random((n, n)) < 0.5, maps),
        "sparse": sense_nufft_op(traj, maps, oversamp=1.5, width=4,
                                 interp="sparse")[0],
        "tile": sense_nufft_op(traj, maps, oversamp=2.0, width=4)[0],
    }


def _rows(mod, op):
    v = mod.Memusage()
    v.visit(op)
    return v.rows


@pytest.mark.parametrize("kind", ["dense", "cartesian", "sparse", "tile"])
def test_memusage_rows_equal_the_reference(rng, kind):
    A = _trees(rng)[kind]
    T = convert.operator_from_reference(A, device="cpu")
    jr, tr = _rows(ja, A), _rows(ta, T)
    assert [(n, tuple(s)) for n, s, _ in tr] == \
        [(n, tuple(s)) for n, s, _ in jr]
    assert sum(b for _, _, b in tr) == T.memusage()
    # leaves both packages store alike: equal payload bytes
    alike = ("Map", "Diag", "fftshift", "UnscaledFFT", "DenseMatrix",
             "Product", "PerCoil", "Coils", "KronI", "VStack", "Adjoint")
    for (name, _, jb), (_, _, tb) in zip(jr, tr):
        if name.startswith(alike):
            assert tb == jb, name
    jl = ja.memusage_report(A).splitlines()
    tl = ta.memusage_report(T).splitlines()
    assert tl[0] == jl[0] and len(tl) == len(jl) == len(tr) + 2
    assert [ln[:37] for ln in tl[1:-1]] == [ln[:37] for ln in jl[1:-1]]
    assert tl[-1].split() == ["TOTAL", f"{T.memusage():,}"]
    if kind == "dense":
        assert tl == jl


@pytest.mark.parametrize("kind,ncols", [("dense", 1), ("dense", 3),
                                        ("cartesian", 2), ("sparse", 3)])
def test_apply_cost_equals_the_reference(rng, kind, ncols):
    A = _trees(rng)[kind]
    T = convert.operator_from_reference(A, device="cpu")
    jf, jb = ja.apply_cost(A, ncols)
    tf, tb = ta.apply_cost(T, ncols)
    assert (tf, tb) == T.cost(ncols)
    assert tf == jf
    if kind in ("dense", "cartesian"):
        assert tb == jb


def test_apply_cost_raises_on_a_leaf_without_cost():
    class Bare(tit.Operator):
        shape = (2, 2)

    with pytest.raises(NotImplementedError):
        ta.apply_cost(Bare())


def test_analyses_are_exported_as_in_the_reference():
    assert sorted(ta.__all__) == sorted(ja.__all__)
    assert tit.analyses is ta and "analyses" in tit.__all__


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
@pytest.mark.parametrize("seed", [0, 7])
def test_randM_equals_the_reference(seed, dtype):
    a = randM(40, 30, density=0.2, rng=seed, dtype=dtype)
    b = j_randM(40, 30, density=0.2, rng=seed, dtype=dtype)
    assert a.shape == b.shape and a.dtype == b.dtype == dtype
    for x, y in ((a.indptr, b.indptr), (a.indices, b.indices),
                 (a.data, b.data)):
        np.testing.assert_array_equal(x, y)
    g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
    assert (randM(5, 5, rng=g1) != j_randM(5, 5, rng=g2)).nnz == 0
    assert randM(3, 3, density=0.0, rng=1).nnz == 1


def test_timer():
    with Timer("work") as t:
        time.sleep(0.02)
    assert 0.02 <= t.elapsed < 2.0
    assert repr(t).startswith("Timer('work', elapsed=0.0")
    with JTimer("work") as j:
        pass
    assert repr(j).split("elapsed")[0] == repr(t).split("elapsed")[0]
    with pytest.raises(KeyError):       # exceptions pass through
        with Timer() as t2:
            raise KeyError
    assert t2.elapsed > 0
