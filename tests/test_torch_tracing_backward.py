"""The backward's spans and counters of a ``SenseRecon`` call on the CPU.

A call whose k-space tensor requires grad (grad mode on) hooks its graph:
under a profiler its backward records ``indigo.backward`` (attr
``saved_bytes``) > ``indigo.solve_bwd`` > ``indigo.normal_op``
(``backward=True``, one per normal-op launch on a cotangent) and
``indigo.rhs_bwd``, every span with the forward's request id. The normal
op and the adjoint pad-DFT run here through the autograd Functions that
carry K1 and the pad-DFT kernel on the card (``_SenseNormalFn``,
``_PadIdftFn``) with their plain launches, so that their backward spans
and counters show. A call without a graph records exactly the spans it
recorded before the backward had any, and an image in host memory carries
no graph.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from indigo_tpu_torch import tracing
from indigo_tpu_torch.models.recon import host_array, host_copy
from indigo_tpu_torch.ops import dft_cuda, pad_dft_cuda

from test_torch_tracing import ITERS, NC, REQUEST_SPANS, recon  # noqa: F401

BACKWARD_SPANS = {"indigo.backward": 1, "indigo.solve_bwd": 1,
                  "indigo.rhs_bwd": 1,
                  "indigo.normal_op": ITERS * NC}  # coil_chunk 1


@pytest.fixture
def functions(monkeypatch):
    """The plain normal op and adjoint pad-DFT routed through the
    Functions the card's kernels run in."""
    plain = dft_cuda.sense_normal_reference
    monkeypatch.setattr(dft_cuda, "sense_normal_reference", lambda Tf, m, v:
                        dft_cuda._SenseNormalFn.apply(
                            lambda T, u, mm, ev: plain(T, mm, u), Tf, m, v))

    def pad_idft(x, img_shape):
        return pad_dft_cuda._PadIdftFn.apply(
            pad_dft_cuda.pad_idft_reference, x,
            tuple(int(n) for n in img_shape))
    pad_idft.backward_calls = 0   # the wrapper's counter (the backward's)
    monkeypatch.setattr(pad_dft_cuda, "pad_dft_serves", lambda *a: True)
    monkeypatch.setattr(pad_dft_cuda, "pad_idft_cuda", pad_idft)


def step(rec, y):
    """One graph-carrying request and its backward: the image loss
    1/2 ||x||^2 in the k-space."""
    yg = torch.from_numpy(y).requires_grad_()
    x = rec(yg, output="device")
    (0.5 * torch.view_as_real(x).square().sum()).backward()
    return yg.grad


def traced(fn):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    recs = [s for s in tracing.spans()
            if not s.name.startswith("indigo.init")]
    tracing.clear()
    return recs, out


def test_a_graph_carrying_request_records_the_backward_tree(recon,
                                                             functions):
    rec, y = recon
    recs, grad = traced(lambda: step(rec, y))
    assert grad is not None and bool(torch.isfinite(grad).all())
    by_id = {s.id: s for s in recs}
    fwd = {s.id for s in recs if s.name == "indigo.solve"}
    bwd = [s for s in recs if s.name in BACKWARD_SPANS
           and not (s.name == "indigo.normal_op"
                    and not s.attrs.get("backward"))]
    assert Counter(s.name for s in bwd) == BACKWARD_SPANS
    want = {"indigo.backward": None, "indigo.solve_bwd": "indigo.backward",
            "indigo.rhs_bwd": "indigo.backward",
            "indigo.normal_op": "indigo.solve_bwd"}
    for s in bwd:
        parent = by_id[s.parent].name if s.parent is not None else None
        assert parent == want[s.name], s
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # the forward's request id on every span, the backward's included
    assert len({s.request for s in recs}) == 1
    assert recs[0].request is not None
    top = next(s for s in bwd if s.name == "indigo.backward")
    assert top.attrs["saved_bytes"] > 0
    # the rhs's reverse follows CG's, both after the forward
    solve_bwd, rhs_bwd = (next(s for s in bwd if s.name == n)
                          for n in ("indigo.solve_bwd", "indigo.rhs_bwd"))
    assert solve_bwd.end_ns <= rhs_bwd.start_ns
    assert all(by_id[i].end_ns <= top.start_ns for i in fwd)
    # the forward's spans are today's, the normal op's without the attr
    fwd_recs = [s for s in recs if s not in bwd]
    assert Counter(s.name for s in fwd_recs) == Counter(REQUEST_SPANS) \
        - Counter({"indigo.egress": 1})
    assert all(not s.attrs.get("backward") for s in fwd_recs)


def test_saved_bytes_count_the_graph_and_leave_the_buffers_out(recon,
                                                               functions):
    rec, y = recon
    recs, _ = traced(lambda: step(rec, y))
    saved = next(s for s in recs if s.name == "indigo.backward").attrs[
        "saved_bytes"]
    # at least p, Ap and the residual of each CG step, each an image
    image = 8 * int(np.prod(rec.img_shape))
    assert saved >= 3 * ITERS * image
    assert saved < sum(b.untyped_storage().nbytes() for b in rec.buffers()) \
        + 20 * ITERS * image


@pytest.mark.parametrize("how", ["numpy", "tensor", "no_grad"])
def test_a_call_without_a_graph_records_todays_spans(recon, functions, how):
    rec, y = recon
    if how == "numpy":
        arg = y
    elif how == "tensor":
        arg = torch.from_numpy(y)
    else:
        arg = torch.from_numpy(y).requires_grad_()

    def call():
        with torch.set_grad_enabled(how != "no_grad"):
            return rec(arg)
    recs, x = traced(call)
    assert Counter(s.name for s in recs) == REQUEST_SPANS
    assert isinstance(x, np.ndarray)
    assert all(s.attrs.get("backward") is None for s in recs)


def test_the_backward_counters_count_one_per_function_backward(recon,
                                                               functions):
    rec, y = recon
    k1, pad = (dft_cuda.sense_normal_cuda.backward_calls,
               pad_dft_cuda.pad_idft_cuda.backward_calls)
    k2 = dft_cuda.toeplitz_apply_cuda.backward_calls
    step(rec, y)
    assert dft_cuda.sense_normal_cuda.backward_calls - k1 == ITERS * NC
    assert pad_dft_cuda.pad_idft_cuda.backward_calls - pad == 1
    assert dft_cuda.toeplitz_apply_cuda.backward_calls == k2
    # without a graph, nothing runs backward
    rec(y)
    assert dft_cuda.sense_normal_cuda.backward_calls - k1 == ITERS * NC


def test_no_backward_span_without_a_profiler(recon, functions):
    rec, y = recon
    tracing.clear()
    step(rec, y)
    assert tracing.spans() == []


def test_host_copy_of_a_tensor_that_requires_grad(recon):
    rec, y = recon
    plain = rec(y)
    yg = torch.from_numpy(y).requires_grad_()
    np.testing.assert_array_equal(rec(yg), plain)
    x = rec(torch.from_numpy(y).requires_grad_(), output="device")
    assert x.requires_grad
    out = host_array(host_copy(x))
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, plain)


def test_the_graph_is_freed_after_the_backward(recon, functions,
                                               monkeypatch):
    """Every tensor the forward saved dies with the request, by reference
    counts alone, the parts of the graph the backward never runs (CG's
    residual history) included."""
    import gc
    import weakref

    from indigo_tpu_torch.models import recon as recon_mod
    rec, y = recon
    pack, packed = recon_mod._BackwardSpans.pack, []

    def spy(self, t):
        out = pack(self, t)
        packed.append(weakref.ref(out))
        return out
    monkeypatch.setattr(recon_mod._BackwardSpans, "pack", spy)
    gc.disable()
    try:
        step(rec, y)
        assert packed and all(w() is None for w in packed)
    finally:
        gc.enable()
