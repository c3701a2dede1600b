"""The readers of the program's spans (``lib/spans.py``) on the CPU: each
new metric reads a recorder filled by the configuration's own request path,
reads None where the program recorded no such span or has no spans at all
(a checkout before them), and resolves through ``spec.metrics`` in the
cells its entry names. The CPU takes no CUDA events, so the request spans'
device ms are filled in here from their host ms; the card's own readings
are the traced runs'."""
import sys
from collections import Counter
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.lib import spans, spec

from .test_portbench_harness import SMALL

BENCH = spec.benchmark()
NEW = {"rhs_ms.interactive", "solve_ms.interactive", "cg_self_ms.interactive",
       "rhs_ms.stream", "solve_ms.stream", "cg_self_ms.stream", "init_s"}
CTX = SimpleNamespace(summary={"requests": 2})
CONFIG = "kooshball3d-256c8"


def reader(name):
    return spec.module("metrics", name).read


@pytest.fixture(scope="module")
def filled():
    """The port's recorder after set-up and two traced requests of the
    configuration at a small size on the CPU, device ms = host ms."""
    from indigo_tpu_torch import tracing

    cfg = dict(spec.config(CONFIG), **SMALL[CONFIG])
    system = spec.module("configs", CONFIG).System(cfg, 4100000009, "cpu")
    pool = system.make_pool(2)
    tracing.clear()
    system.build()
    with profile(activities=[ProfilerActivity.CPU]):
        for y in pool:
            system.serve(y)
    recs = tracing.spans()
    for s in recs:
        if s.name in ("indigo.rhs", "indigo.ingress", "indigo.solve",
                      "indigo.cg_iter", "indigo.normal_op", "indigo.egress"):
            s.device_ms = s.host_ms
    yield cfg, recs
    tracing.clear()


def test_the_recorder_holds_the_request_path(filled):
    cfg, recs = filled
    count = Counter(s.name for s in recs)
    assert count["indigo.init"] == 1
    assert count["indigo.rhs"] == count["indigo.solve"] == 2
    assert count["indigo.normal_op"] == 2 * cfg["iters"]


def test_each_metric_reads_the_recorder(filled):
    cfg, recs = filled

    def named(name):
        return [s for s in recs if s.name == name]

    rhs = [s.device_ms - c.device_ms for s in named("indigo.rhs")
           for c in named("indigo.ingress") if c.parent == s.id]
    solve = [s.device_ms for s in named("indigo.solve")]
    normal = {s.id: 0.0 for s in named("indigo.solve")}
    iters = {s.id: s.parent for s in named("indigo.cg_iter")}
    for s in named("indigo.normal_op"):
        normal[iters[s.parent]] += s.device_ms
    cg_self = [s.device_ms - normal[s.id] for s in named("indigo.solve")]
    init = named("indigo.init")[0]
    want = {"rhs_ms": sum(rhs) / 2, "solve_ms": sum(solve) / 2,
            "cg_self_ms": sum(cg_self) / 2}
    for cell in ("interactive", "stream"):
        for m, v in want.items():
            assert reader(f"{m}.{cell}")(CTX) == pytest.approx(v), m
    assert 0 < want["cg_self_ms"] < want["solve_ms"]
    assert reader("init_s")(CTX) == pytest.approx(
        (init.end_ns - init.start_ns) / 1e9)


def test_without_device_ms_or_spans_the_metrics_read_none(filled):
    _, recs = filled
    kept = [s.device_ms for s in recs]
    for s in recs:
        s.device_ms = None
    try:
        for name in NEW - {"init_s"}:
            assert reader(name)(CTX) is None, name
        assert reader("init_s")(CTX) > 0    # set-up is on the host clock
    finally:
        for s, ms in zip(recs, kept):
            s.device_ms = ms


def test_a_program_without_spans_reads_none(monkeypatch):
    import indigo_tpu_torch
    monkeypatch.delattr(indigo_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "indigo_tpu_torch.tracing", None)
    assert spans.records() is None
    for name in NEW:
        assert reader(name)(CTX) is None, name


def test_no_span_recorded_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: [])
    for name in NEW:
        assert reader(name)(CTX) is None, name


def test_without_a_traced_stretch_no_request_metric_reads(filled):
    for name in NEW - {"init_s"}:
        assert reader(name)(SimpleNamespace(summary=None)) is None, name


def test_new_entries_resolve_to_their_files_in_their_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    assert NEW <= set(entries)
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["workloads"]
        for cell in m["workloads"]:
            got = {e["name"]: mod for e, mod in spec.metrics(
                BENCH, spec.workload(BENCH, cell), True)}
            assert got[name].__file__ == spec.path("metrics", name, ".py")
        for cell in {w["name"] for w in BENCH["workloads"]} - set(
                m["workloads"]):
            assert name not in {e["name"] for e, _ in spec.metrics(
                BENCH, spec.workload(BENCH, cell), True)}
        assert name not in {e["name"] for w in BENCH["workloads"]
                            for e, _ in spec.metrics(BENCH, w, False)}


def test_a_traced_cpu_run_reads_set_up_and_no_device_metric():
    from portbench.lib import harness
    cell = "kooshball3d-256c8.interactive"
    r = harness.run_cell(cell, 4200000011, 0.3, True, device="cpu",
                         overrides=SMALL[CONFIG])
    got = set(r["metrics"])
    assert "init_s" in got and r["metrics"]["init_s"]["unit"] == "s"
    assert not got & (NEW - {"init_s"})
