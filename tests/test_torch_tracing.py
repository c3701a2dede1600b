"""The port's layer spans (``indigo_tpu_torch.tracing``) on the CPU.

Off (no profiler running) a span checks the profiler's state once and does
nothing else; under a profiler one ``SenseRecon`` call gives the tree
rhs > ingress, solve > cg_iter > normal_op, egress, with one request id,
each span a host event of the profiler's own trace (never a user
annotation) on its clock. ``solvers.cg`` on the operator tree gives solve >
(normal_op, cg_iter > normal_op) > toeplitz, and 64-bit host data records
one narrow span where the boundary casts it (32-bit records none). Set-up
phases are recorded without a profiler and kept apart from the bounded
request buffer.
"""
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from indigo_tpu_torch import profiling, solvers, tracing
from indigo_tpu_torch.convert import state_from_reference_arrays
from indigo_tpu_torch.models import SenseRecon
from indigo_tpu_torch.utils import rand64c

N, NC, ITERS = 16, 2, 3
REQUEST_SPANS = {"indigo.rhs": 1, "indigo.ingress": 1, "indigo.solve": 1,
                 "indigo.cg_iter": ITERS, "indigo.normal_op": ITERS,
                 "indigo.egress": 1}
SLACK_NS = 50_000  # the profiler's clock conversion


@pytest.fixture(scope="module")
def recon():
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((64, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = (np.arange(N) - N // 2) / N
    traj = (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)
    maps = (0.5 + 0.1 * rand64c(NC, N, N, N, rng=rng)).astype(np.complex64)
    rec = SenseRecon(traj, maps, iters=ITERS, coil_chunk=1, device="cpu")
    rec.geometry = traj, maps
    return rec, rand64c(NC * len(traj), rng=rng)


def kineto(prof):
    return list(prof.profiler.kineto_results.events())


def traced(rec, y, calls=1):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            rec(y)
    return [s for s in tracing.spans() if s.name in REQUEST_SPANS], prof


class Count:
    def __init__(self, fn=None):
        self.n, self.fn = 0, fn

    def __call__(self, *a, **k):
        self.n += 1
        return self.fn(*a, **k) if self.fn is not None else None


def test_off_checks_the_profiler_once_per_span_and_nothing_else(
        recon, monkeypatch):
    rec, y = recon
    rec(y)
    tracing.clear()
    checks = Count(tracing._profiling)
    clock = Count(time.time_ns)
    made, scopes, events = Count(), Count(), Count()
    inited = Count(torch.cuda.is_initialized)
    monkeypatch.setattr(tracing, "_profiling", checks)
    monkeypatch.setattr(tracing.time, "time_ns", clock)
    monkeypatch.setattr(tracing, "Span", made)
    monkeypatch.setattr(tracing, "_Scope", scopes)
    monkeypatch.setattr(torch.cuda, "Event", events)
    monkeypatch.setattr(torch.cuda, "is_initialized", inited)
    rec(y)
    # one check per span and one for the call's request id
    assert checks.n == sum(REQUEST_SPANS.values()) + 1
    assert (clock.n, made.n, scopes.n, events.n, inited.n) == (0, 0, 0, 0, 0)
    assert tracing.spans() == []
    with tracing.span("indigo.x", bytes=1) as s:
        assert s is None
    assert checks.n == sum(REQUEST_SPANS.values()) + 2


def test_one_call_gives_the_layer_tree(recon):
    rec, y = recon
    recs, _ = traced(rec, y)
    assert Counter(s.name for s in recs) == REQUEST_SPANS
    by_id = {s.id: s for s in recs}

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None

    want = {"indigo.rhs": None, "indigo.ingress": "indigo.rhs",
            "indigo.solve": None, "indigo.cg_iter": "indigo.solve",
            "indigo.normal_op": "indigo.cg_iter", "indigo.egress": None}
    for s in recs:
        assert parent(s) == want[s.name], s
        assert s.end_ns >= s.start_ns
        assert s.device_ms is None   # no CUDA events on the CPU
    assert len({s.request for s in recs}) == 1
    assert recs[0].request is not None
    nbytes = 8 * NC * rec.n_samples
    assert by_name(recs, "indigo.ingress")[0].attrs == {"bytes": nbytes}
    assert by_name(recs, "indigo.egress")[0].attrs == {
        "bytes": 8 * N ** 3}
    # spans of a call nest inside their parent's host interval
    for s in recs:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def by_name(recs, name):
    return [s for s in recs if s.name == name]


def test_each_call_has_its_own_request_id(recon):
    rec, y = recon
    recs, _ = traced(rec, y, calls=2)
    ids = sorted({s.request for s in recs})
    assert len(ids) == 2
    for rid in ids:
        assert Counter(s.name for s in recs if s.request == rid) \
            == REQUEST_SPANS


def test_spans_are_host_events_of_the_profiler_on_its_clock(recon):
    rec, y = recon
    recs, prof = traced(rec, y)
    ev = [e for e in kineto(prof) if e.name().startswith("indigo.")]
    assert Counter(e.name() for e in ev) == REQUEST_SPANS
    for e in ev:
        assert not e.is_user_annotation()
        assert "CUDA" not in str(e.device_type())
    for name in REQUEST_SPANS:
        mine = sorted(by_name(recs, name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in ev if e.name() == name),
                        key=lambda e: e.start_ns())
        # one clock: the span's stamps fall inside its profiler event,
        # which opens before the start stamp and closes after the end
        # stamp (a pre-emption between the two only widens the event)
        for s, e in zip(mine, theirs):
            assert e.start_ns() - SLACK_NS <= s.start_ns, name
            assert s.end_ns <= e.end_ns() + SLACK_NS, name


def test_chrome_trace_carries_the_spans(recon, tmp_path):
    rec, y = recon
    with profiling.trace(tmp_path):
        rec(y)
    with open(tmp_path / "trace.json") as f:
        names = Counter(e.get("name") for e in json.load(f)["traceEvents"])
    for name, n in REQUEST_SPANS.items():
        assert names[name] == n, name


@pytest.mark.parametrize("maxiter,tol", [(4, 0.0), (6, 1e-2)])
def test_solvers_cg_records_one_iteration_per_step(maxiter, tol):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((12, 12)).astype(np.float32)
    A = torch.from_numpy(a @ a.T + 12 * np.eye(12, dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        solvers.cg(lambda v: A @ v, b, tol=tol, maxiter=maxiter)
    recs = tracing.spans()
    # the solve, its zero start's residual apply, then each step with the
    # operator apply inside it
    assert [s.name for s in recs] == (
        ["indigo.solve", "indigo.normal_op"]
        + ["indigo.cg_iter", "indigo.normal_op"] * maxiter)
    solve = recs[0]
    assert solve.parent is None
    assert recs[1].parent == solve.id
    for it, op in zip(recs[2::2], recs[3::2]):
        assert it.parent == solve.id and op.parent == it.id


def toeplitz_tree(n=8, nc=2, seed=3):
    from indigo_tpu_torch.toeplitz import sense_normal_toeplitz
    rng = np.random.default_rng(seed)
    Tf = (1.0 + rng.random((2 * n,) * 3)).astype(np.float32)
    maps = (0.5 + 0.1 * rand64c(nc, n, n, n, rng=rng)).astype(np.complex64)
    return sense_normal_toeplitz(Tf, maps, device="cpu"), \
        torch.from_numpy(rand64c(n ** 3, rng=rng))


@pytest.mark.parametrize("maxiter", [3, 5])
def test_a_tree_solve_gives_solve_iter_normal_op_toeplitz(maxiter):
    N, b = toeplitz_tree()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        solvers.cg(N, b, lamda=0.1, tol=0.0, maxiter=maxiter)
    recs = tracing.spans()
    tracing.clear()
    count = Counter(s.name for s in recs)
    assert count == {"indigo.solve": 1, "indigo.cg_iter": maxiter,
                     "indigo.normal_op": maxiter + 1,
                     "indigo.toeplitz": maxiter + 1}
    by_id = {s.id: s for s in recs}

    def chain(s):
        out = []
        while s is not None:
            out.append(s.name)
            s = by_id.get(s.parent)
        return out

    leaves = [chain(s) for s in recs if s.name == "indigo.toeplitz"]
    assert leaves[0] == ["indigo.toeplitz", "indigo.normal_op",
                         "indigo.solve"]
    assert all(c == ["indigo.toeplitz", "indigo.normal_op",
                     "indigo.cg_iter", "indigo.solve"] for c in leaves[1:])
    # one apply of the leaf per operator apply, the coils in its batch
    assert all(s.attrs == {"K": 2, "method": "pallas"} for s in recs
               if s.name == "indigo.toeplitz")
    for s in recs:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_a_tree_solve_off_records_nothing():
    N, b = toeplitz_tree()
    tracing.clear()
    solvers.cg(N, b, lamda=0.1, tol=0.0, maxiter=2)
    assert tracing.spans() == []


def recorded(fn):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    recs = tracing.spans()
    tracing.clear()
    return recs


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_the_pipeline_narrows_64_bit_k_space_in_a_span(recon, dtype):
    rec, y = recon
    recs = recorded(lambda: rec(y.astype(dtype)))
    narrow = by_name(recs, "indigo.narrow")
    if dtype == np.complex64:
        assert narrow == []
    else:
        (s,) = narrow
        by_id = {r.id: r for r in recs}
        assert by_id[s.parent].name == "indigo.ingress"
        assert s.attrs == {"bytes": y.astype(dtype).nbytes}
    # the rest of the call's tree is the complex64 call's
    assert Counter(r.name for r in recs if r.name != "indigo.narrow") \
        == REQUEST_SPANS


@pytest.mark.parametrize("dtype,narrows", [
    (np.complex64, False), (np.float32, False), (np.int64, False),
    (np.complex128, True), (np.float64, True)])
def test_as_tensor_narrows_64_bit_host_data_in_a_span(dtype, narrows):
    from indigo_tpu_torch.utils import as_tensor
    a = np.arange(6).astype(dtype)
    out = []
    recs = recorded(lambda: out.append(as_tensor(a, "cpu")))
    assert [s.name for s in recs] == ["indigo.narrow"] * narrows
    if narrows:
        assert recs[0].attrs == {"bytes": a.nbytes}
        assert out[0].element_size() == a.itemsize // 2
    # a dtype asked for is the caller's cast, not the boundary's narrowing
    assert recorded(lambda: as_tensor(a, "cpu", torch.complex64)) == []


def test_setup_spans_without_a_profiler(recon):
    rec, _ = recon
    core = rec.A.left.child    # GridDFT, or KBInterp . CenteredDFT
    g = core.plan if hasattr(core, "plan") else core.left.plan
    state = state_from_reference_arrays(
        Tf=np.zeros((2 * N,) * 3, np.float32), maps=rec.geometry[1],
        w_sorted=rec.wd.numpy(), perm=rec.plan.perm,
        deapod=rec.plan.deapod, tid=g.tid, wfac=g.wfac,
        grid_shape=g.grid_shape, tile=g.tile, ext=g.ext, nt=g.nt,
        pad_lo=g.pad_lo, width=g.width, lamda=rec.lamda, iters=ITERS)
    tracing.clear()
    SenseRecon.from_arrays(state, device="cpu")
    recs = tracing.spans()
    assert [s.name for s in recs] == ["indigo.init", "indigo.init.setup"]
    assert recs[1].parent == recs[0].id
    assert all(s.device_ms is None and s.host_ms > 0 for s in recs)


def test_setup_phases_of_the_pipeline(recon):
    rec, _ = recon
    tracing.clear()
    SenseRecon(*rec.geometry, iters=ITERS, device="cpu")
    recs = tracing.spans()
    assert [s.name for s in recs] == [
        "indigo.init", "indigo.init.dcf", "indigo.init.plan",
        "indigo.init.toeplitz", "indigo.init.setup"]
    assert all(s.parent == recs[0].id for s in recs[1:])
    assert sum(s.host_ms for s in recs[1:]) <= recs[0].host_ms


def test_request_spans_never_evict_setup_spans(monkeypatch):
    monkeypatch.setattr(tracing, "REQUEST_SPANS", 8)
    monkeypatch.setattr(tracing, "SETUP_SPANS", 4)
    rec = tracing.Recorder()
    with rec.span("indigo.init", setup=True):
        with rec.span("indigo.init.plan", setup=True):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(50):
            with rec.request(k), rec.span("indigo.solve"):
                with rec.span("indigo.cg_iter"):
                    pass
    recs = rec.spans()
    assert [s.name for s in recs[:2]] == ["indigo.init", "indigo.init.plan"]
    assert len(rec.requests) == 8 and len(recs) == 10
    # the newest spans are the ones kept
    assert {s.request for s in recs[2:]} == {46, 47, 48, 49}
    for k in range(10):
        with rec.span(f"indigo.init.{k}", setup=True):
            pass
    assert len(rec.setup) == 4 and len(rec.requests) == 8


def test_module_buffer_stays_bounded(recon):
    rec, y = recon
    tracing.clear()
    limit = tracing.RECORDER.requests.maxlen
    assert limit == tracing.REQUEST_SPANS
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(limit // 8 + 1):
            with tracing.span("indigo.solve"):
                for _ in range(7):
                    with tracing.span("indigo.cg_iter"):
                        pass
    assert len(tracing.spans()) == limit
    tracing.clear()


def test_self_ms_subtracts_the_nearest_named_descendants():
    rec = tracing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("indigo.solve"):
            for _ in range(2):
                with rec.span("indigo.cg_iter"):
                    with rec.span("indigo.normal_op"):
                        pass
    recs = rec.spans()
    for s, ms in zip(recs, (10.0, 4.0, 3.0, 4.5, 3.5)):
        s.device_ms = ms
    solve = recs[0]
    assert tracing.self_ms(solve, recs) == pytest.approx(10.0 - 8.5)
    assert tracing.self_ms(solve, recs, ("indigo.normal_op",)) \
        == pytest.approx(10.0 - 6.5)
    recs[2].device_ms = None
    assert tracing.self_ms(solve, recs, ("indigo.normal_op",)) is None
    assert tracing.self_ms(recs[2], recs) is None
