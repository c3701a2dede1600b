"""The cell ``toeplitz3d-256c8.interactive`` and the held-back
``kooshball3d-256c8.numpy128`` on the CPU: the tree cell's files resolve by
name; a small run of each is correct and loads no ``jax`` (the held-back
cell from its own files and one workload entry added to a copy of the
tree); the frozen K2 bound and the tree cell's roofline against hand
counts; the span readers of the tree and of the narrowing against the
recorder filled by each configuration's own request path; the TF32 control
failing the tree cell's limits; and the tree cell's timed path, broken
underneath, reading ``correct`` false."""
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import readings
from portbench.lib import harness, spans, spec
from portbench.roofline import bounds

BENCH = spec.benchmark()
TREE, NUMPY128 = "toeplitz3d-256c8.interactive", "kooshball3d-256c8.numpy128"
SMALL = {
    "toeplitz3d-256c8": {"image": [24, 24, 24], "coils": 4, "spokes": 384,
                         "readout": 24},
    "kooshball3d-256c8": {"image": [24, 24, 24], "coils": 4, "spokes": 384,
                          "readout": 24, "coil_chunk": 2},
}
METRICS = {
    TREE: {"solve_ms.toeplitz3d", "cg_self_ms.toeplitz3d",
           "coil_ops_ms.toeplitz3d", "toeplitz_ms.toeplitz3d",
           "toeplitz_roofline.toeplitz3d"},
    NUMPY128: {"narrow_ms.numpy128"},
}


def small(cell):
    return SMALL[cell.split(".")[0]]


def test_the_tree_cell_resolves_to_its_files():
    w = spec.workload(BENCH, TREE)
    assert w["chips"] == 1
    for kind in ("configs", "reference"):
        assert os.path.isfile(spec.path(kind, w["config"], ".py"))
    assert spec.limits(TREE).keys() == {"img_rel_l2", "img_rel_max"}
    e2e = {e["name"] for e, _ in spec.metrics(BENCH, w, False)}
    assert e2e == {"recon_per_s", "recon_s_p90", "setup_s"}
    layer = {e["name"]: m for e, m in spec.metrics(BENCH, w, True)}
    assert set(layer) == METRICS[TREE]
    for name, mod in layer.items():
        assert mod.__file__ == spec.path("metrics", name, ".py")
    assert NUMPY128 not in {c["name"] for c in BENCH["workloads"]}


def test_the_tree_configuration_states_the_recipe():
    cfg = spec.config("toeplitz3d-256c8")
    koosh = spec.config("kooshball3d-256c8")
    for k in ("image", "coils", "spokes", "readout", "trajectory_seed",
              "oversamp", "width", "iters", "tol", "noise", "lamda"):
        assert cfg[k] == koosh[k], k
    assert (cfg["dcf"], cfg["dcf_iters"], cfg["reduced"]) == (
        "pipe_menon", 20, [])
    assert {"dcf_iters", "maps_and_phantoms"} <= set(cfg["assumed"])
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == "toeplitz3d-256c8")
    assert entry["source"] == cfg["source"]


RUN = """
import json, sys
sys.path[:0] = [{tmp!r}, {root!r}]
from portbench.lib import harness
r = harness.run_cell({cell!r}, 4300000001, 0.3, False, device="cpu",
                     overrides={small!r})
r["loaded"] = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(r))
"""


def digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def held_back(tmp_path):
    """A copy of the tree with the numpy128 cell and its metric entered in
    BENCHMARK.json: its mix, limits and reader are files of their own."""
    shutil.copy(spec.BENCHMARK, tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": NUMPY128, "config": "kooshball3d-256c8",
        "traffic": "numpy128", "chips": 1, "why": "held back"})
    for m in bench["end_to_end"]:
        if m["name"] in ("recon_per_s", "recon_s_p90"):
            m["workloads"].append(NUMPY128)
    bench["per_layer"].append({
        "name": "narrow_ms.numpy128", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "boundary in", "moves":
        "recon_per_s", "workloads": [NUMPY128]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


@pytest.mark.parametrize("cell", [TREE, NUMPY128])
def test_a_small_run_is_correct_and_loads_no_jax(cell, tmp_path):
    root = spec.ROOT
    if cell == NUMPY128:
        bench = held_back(tmp_path)
        w = spec.workload(bench, cell)
        assert spec.mix(w["traffic"])["dtype"] == "complex128"
        assert {e["name"] for e, _ in spec.metrics(bench, w, True)} \
            == METRICS[NUMPY128]
        before, root = digest(spec.HERE), str(tmp_path)
    code = RUN.format(tmp=root, root=spec.ROOT, cell=cell, small=small(cell))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert not set(result["loaded"]) & set(harness.BANNED)
    assert "indigo_tpu_torch" in result["loaded"]
    if cell == NUMPY128:
        after = digest(tmp_path / "portbench")
        assert {k: after[k] for k in before} == before


def test_k2_bound_at_256_cubed_against_a_hand_count():
    # 8 bare volumes of V = 2^24: each FFT round trip on the doubled grid
    # 20 + 40 + 80 flops x V log2(256) = 1120 V, the spectrum multiply
    # 16 V; 8 volumes in and out (16 x 8 V bytes) and the spectrum (32 V)
    V = 256 ** 3
    flops = 8 * (1120 * V + 16 * V)
    ms, what = bounds.toeplitz_bound((256, 256, 256), 8, 0)
    assert what == "operations"
    assert ms == pytest.approx(1e3 * flops / 67e12)
    assert ms == pytest.approx(2.276, abs=5e-4)
    assert 1e3 * 160 * V / 3.35e12 < ms


def fake(name, **attrs):
    return SimpleNamespace(name=name, attrs=attrs, end_ns=1, host_ms=0.0)


def test_toeplitz_roofline_against_a_hand_count(monkeypatch):
    reader = spec.module("metrics", "toeplitz_roofline.toeplitz3d")
    cfg = {"image": [8, 8, 8], "coils": 2}
    bound_ms, _ = bounds.toeplitz_bound((8, 8, 8), 2, 0)
    recs = [fake("indigo.solve")] + [
        fake("indigo.toeplitz", K=2, method="pallas") for _ in range(6)]
    monkeypatch.setattr(spans, "records", lambda: recs)
    kern = {"kern_fwd<16,16,false>": 1e-3, "kern_x<16,16>": 2e-3,
            "kern_inv<16,16,false>": 1e-3, "cublas_gemm": 5.0,
            "elementwise_kernel": 1.0}
    s = {"requests": 2, "by_name": kern,
         "count_by_name": dict.fromkeys(kern, 6)}
    ctx = SimpleNamespace(summary=s, cfg=cfg)
    # 6 applies of 2 volumes over 4 ms of the pass family's kernels
    assert reader.read(ctx) == pytest.approx(100 * 6 * bound_ms / 4.0)
    # each apply counts at its own batch
    recs[1].attrs["K"] = 4
    assert reader.read(ctx) == pytest.approx(100 * (
        5 * bound_ms + bounds.toeplitz_bound((8, 8, 8), 4, 0)[0]) / 4.0)
    s["by_name"] = {"cublas_gemm": 5.0}
    assert reader.read(ctx) is None
    s["by_name"] = kern
    monkeypatch.setattr(spans, "records", lambda: [fake("indigo.solve")])
    assert reader.read(ctx) is None
    assert reader.read(SimpleNamespace(summary=None, cfg=cfg)) is None


def traced(cell, dtype):
    """The recorder after two traced requests of the cell's configuration
    at a small size on the CPU, device ms = host ms (the CPU takes no CUDA
    events)."""
    from indigo_tpu_torch import tracing
    config = cell.split(".")[0]
    cfg = dict(spec.config(config), **small(cell))
    system = spec.module("configs", config).System(cfg, 4100000009, "cpu")
    pool = [y.astype(dtype) for y in system.make_pool(2)]
    system.build()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for y in pool:
            system.serve(y)
    recs = tracing.spans()
    tracing.clear()
    for s in recs:
        s.device_ms = s.host_ms
    return cfg, recs


def test_the_tree_readers_read_the_tree_path(monkeypatch):
    cfg, recs = traced(TREE, np.complex64)
    monkeypatch.setattr(spans, "records", lambda: recs)
    count = Counter(s.name for s in recs)
    iters = cfg["iters"]
    assert count == {"indigo.solve": 2, "indigo.cg_iter": 2 * iters,
                     "indigo.normal_op": 2 * (iters + 1),
                     "indigo.toeplitz": 2 * (iters + 1)}
    by = {n: [s for s in recs if s.name == n] for n in count}
    ctx = SimpleNamespace(summary={"requests": 2}, cfg=cfg)

    def read(name):
        return spec.module("metrics", name).read(ctx)

    solve = sum(s.device_ms for s in by["indigo.solve"]) / 2
    ops = sum(s.device_ms for s in by["indigo.normal_op"])
    toep = sum(s.device_ms for s in by["indigo.toeplitz"])
    n_ops = 2 * (iters + 1)
    assert read("solve_ms.toeplitz3d") == pytest.approx(solve)
    assert read("cg_self_ms.toeplitz3d") == pytest.approx(solve - ops / 2)
    assert read("toeplitz_ms.toeplitz3d") == pytest.approx(toep / n_ops)
    assert read("coil_ops_ms.toeplitz3d") == pytest.approx(
        (ops - toep) / n_ops)
    assert read("narrow_ms.numpy128") is None
    # without a traced stretch, or without the spans, nothing is read
    ctx.summary = None
    assert all(read(m) is None for m in METRICS[TREE])
    ctx.summary = {"requests": 2}
    monkeypatch.setattr(spans, "records", lambda: [
        s for s in recs if s.name not in ("indigo.solve",
                                          "indigo.normal_op",
                                          "indigo.toeplitz")])
    assert all(read(m) is None for m in METRICS[TREE] - {
        "toeplitz_roofline.toeplitz3d"})


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_the_narrowing_reader_reads_complex128_requests(dtype, monkeypatch):
    _, recs = traced(NUMPY128, dtype)
    monkeypatch.setattr(spans, "records", lambda: recs)
    read = spec.module("metrics", "narrow_ms.numpy128").read
    narrow = [s.host_ms for s in recs if s.name == "indigo.narrow"]
    got = read(SimpleNamespace(summary={"requests": 2}))
    if dtype == np.complex64:
        assert narrow == [] and got is None
    else:
        assert len(narrow) == 2
        assert got == pytest.approx(sum(narrow) / 2) and got > 0
    assert read(SimpleNamespace(summary=None)) is None


def test_the_control_fails_the_tree_limits():
    checks = readings.control(TREE, 4000000007, torch.device("cpu"),
                              small(TREE))
    assert [k for k, c in checks.items() if not c["value"] <= c["limit"]]


def zero_centre(x):
    x = x.clone()
    x.reshape(-1)[x.numel() // 2 - x.numel() // 16:
                  x.numel() // 2 + x.numel() // 16] = 0
    return x


def break_tree(monkeypatch, fault):
    import indigo_tpu_torch
    from indigo_tpu_torch import toeplitz
    cg = indigo_tpu_torch.cg
    if fault == "state_unchanged":
        monkeypatch.setattr(indigo_tpu_torch, "cg", lambda *a, **k: cg(
            *a, **dict(k, maxiter=0)))
    elif fault == "half_the_coils":
        normal = toeplitz.sense_normal_toeplitz

        def half(Tf, maps, device=None):
            return 2 * normal(Tf, maps[: len(maps) // 2], device=device)
        monkeypatch.setattr(toeplitz, "sense_normal_toeplitz", half)
    elif fault == "answer_altered":
        def altered(*a, **k):
            x, info = cg(*a, **k)
            return zero_centre(x), info
        monkeypatch.setattr(indigo_tpu_torch, "cg", altered)


@pytest.mark.parametrize("fault", ["none", "state_unchanged",
                                   "half_the_coils", "answer_altered"])
def test_a_broken_tree_path_reads_not_correct(fault, monkeypatch):
    break_tree(monkeypatch, fault)
    result = harness.run_cell(TREE, 4100000009, 0.2, False, device="cpu",
                              overrides=small(TREE))
    assert result["attempted"] >= 1
    assert result["correct"] is (fault == "none"), result["checks"]
    assert math.isfinite(result["checks"]["img_rel_l2"]["value"])
