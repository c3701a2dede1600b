"""The port's checkpoint with the reference's resume contract: round trip,
CG resumed from a checkpoint, restore without a template, and files that
each package reads from the other (given ``like=``). Nothing is
unpickled, and an operator is not state."""
import os

import numpy as np
import pytest
import torch

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu import checkpoint as jc
from indigo_tpu_torch.checkpoint import load_state, save_state
from indigo_tpu_torch.utils import rand64c, rel_err


def _spd(n, rng):
    B = rand64c(n, n, rng=rng)
    A = (B.conj().T @ B + 0.5 * np.eye(n)).astype(np.complex64)
    x = rand64c(n, rng=rng)
    return A, x, (A @ x).astype(np.complex64)


def test_roundtrip(tmp_path, rng):
    x = torch.from_numpy(rand64c(16, rng=rng))
    state = {"x": x, "k": np.int32(7), "resid": np.float32(1e-3),
             "r": torch.arange(5, dtype=torch.float64), "n": 3}
    p = save_state(os.path.join(tmp_path, "ckpt.npz"), state)
    out = load_state(p, like=state)
    assert torch.equal(out["x"], x) and out["x"].dtype == torch.complex64
    assert int(out["k"]) == 7 and out["k"].dtype == np.int32
    assert out["resid"] == np.float32(1e-3) and out["n"] == 3
    assert torch.equal(out["r"], state["r"])
    with np.load(p) as z:
        # the reference's leaf layout: complex leaves as f32 planes
        assert z["leaf4_re"].dtype == np.float32
        assert sorted(k for k in z.files if not k.startswith("__")) == [
            "leaf0", "leaf1", "leaf2", "leaf3", "leaf4_im", "leaf4_re"]


def test_resume_cg(tmp_path, rng):
    """CG resumed from a checkpointed x equals uninterrupted CG."""
    A, _, b = _spd(24, rng)
    Aop = tit.DenseMatrix(A, device="cpu")
    x_full, _ = tit.cg(Aop, b, tol=1e-10, maxiter=60)
    x_half, info = tit.cg(Aop, b, tol=1e-10, maxiter=30)
    p = save_state(os.path.join(tmp_path, "cg.npz"),
                   {"x": x_half, "iters": info["iters"]})
    st = load_state(p, like={"x": x_half, "iters": info["iters"]})
    assert int(st["iters"]) == 30 and torch.is_tensor(st["iters"])
    x_resumed, _ = tit.cg(Aop, b, x0=st["x"], tol=1e-10, maxiter=60)
    assert rel_err(x_resumed, x_full) < 1e-4


def test_restores_without_template(tmp_path, rng):
    """load_state(path) alone rebuilds the nesting (JSON record)."""
    state = {"x": rand64c(9, rng=rng), "k": np.int32(3),
             "nested": [np.float32(1.5), rand64c(2, 3, rng=rng)],
             "t": (torch.ones(2, 2, dtype=torch.complex64), None, 2.5, True),
             "name": "cg"}
    p = save_state(os.path.join(tmp_path, "c.npz"), state)
    out = load_state(p)
    assert set(out) == {"x", "k", "nested", "t", "name"}
    np.testing.assert_array_equal(out["x"], state["x"])
    assert out["k"] == 3 and isinstance(out["k"], np.int32)
    np.testing.assert_array_equal(out["nested"][1], state["nested"][1])
    assert isinstance(out["nested"], list) and isinstance(out["t"], tuple)
    assert torch.equal(out["t"][0], state["t"][0]) and out["t"][1] is None
    assert out["t"][2:] == (2.5, True) and out["name"] == "cg"


def test_reads_a_file_the_reference_wrote(tmp_path, rng):
    state = {"x": rand64c(16, rng=rng), "k": np.int32(7),
             "nested": [np.float32(1.5), rand64c(2, 3, rng=rng)]}
    p = jc.save_state(os.path.join(tmp_path, "ref.npz"), state)
    like = {"x": torch.zeros(16, dtype=torch.complex64), "k": np.int32(0),
            "nested": [np.float32(0), np.zeros((2, 3), np.complex64)]}
    out = load_state(p, like=like)        # the pickled record is not read
    assert torch.is_tensor(out["x"])
    np.testing.assert_array_equal(out["x"].numpy(), state["x"])
    assert out["k"] == 7
    np.testing.assert_array_equal(out["nested"][1], state["nested"][1])
    # no template and no JSON record: the reference's legacy list of leaves
    assert len(load_state(p)) == 4


def test_the_reference_reads_a_file_the_port_wrote(tmp_path, rng):
    state = {"x": torch.from_numpy(rand64c(16, rng=rng)), "k": np.int32(7),
             "nested": [np.float32(1.5), rand64c(2, 3, rng=rng)]}
    p = save_state(os.path.join(tmp_path, "port.npz"), state)
    like = {"x": np.zeros(16, np.complex64), "k": np.int32(0),
            "nested": [np.float32(0), np.zeros((2, 3), np.complex64)]}
    out = jc.load_state(p, like=like)
    np.testing.assert_array_equal(out["x"], state["x"].numpy())
    assert int(out["k"]) == 7
    np.testing.assert_array_equal(out["nested"][1], state["nested"][1])
    # and the reference's own CG resumes from it
    A, _, b = _spd(12, rng)
    Aop = jit_.DenseMatrix(A)
    x_full, _ = jit_.cg(Aop, b, tol=1e-10, maxiter=40)
    x_half, _ = tit.cg(tit.DenseMatrix(A, device="cpu"), b, tol=1e-10,
                       maxiter=20)
    p = save_state(os.path.join(tmp_path, "cg.npz"), {"x": x_half})
    x0 = jc.load_state(p, like={"x": np.zeros(12, np.complex64)})["x"]
    x_res, _ = jit_.cg(Aop, b, x0=x0.astype(np.complex64), tol=1e-10,
                       maxiter=40)
    assert rel_err(np.asarray(x_res), np.asarray(x_full)) < 1e-4


def test_an_operator_is_not_state(tmp_path, rng):
    op = tit.Diag(rand64c(4, rng=rng), device="cpu")
    with pytest.raises(TypeError, match="state_dict"):
        save_state(os.path.join(tmp_path, "op.npz"), {"A": op})
    p = save_state(os.path.join(tmp_path, "sd.npz"), dict(op.state_dict()))
    back = load_state(p)
    assert torch.equal(back["d"], op.d)
    with pytest.raises(TypeError, match="state_dict"):
        load_state(p, like={"d": op})
    with pytest.raises(TypeError):
        save_state(os.path.join(tmp_path, "o.npz"), {"o": object()})


def test_template_must_match(tmp_path, rng):
    p = save_state(os.path.join(tmp_path, "m.npz"),
                   {"a": np.ones(2), "b": np.zeros(3)})
    with pytest.raises(ValueError):
        load_state(p, like={"a": np.ones(2)})
    with pytest.raises(ValueError):
        load_state(p, like={"a": np.ones(2), "b": np.ones(3), "c": 0})
