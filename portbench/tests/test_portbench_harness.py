"""The harness on the CPU: ``BENCHMARK.json``'s keys, names and units
against the allowed forms, its cross-references, the frozen rooflines
against hand counts, the window's rate and tail, no CPU fallback, and the
modules a run loads. Nothing here needs a card."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.lib import harness, readers, spec
from portbench.roofline import bounds

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {
    "kooshball3d-256c8": {"image": [16, 16, 16], "coils": 2, "spokes": 128,
                          "readout": 16, "coil_chunk": 2},
    "radial2d-256c8": {"image": [32, 32], "spokes": 48, "readout": 64,
                       "maxiter": 10},
}


def one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert one_line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert os.path.getsize(spec.BENCHMARK) <= 64 * 1024


def test_every_workload_resolves_to_its_files():
    for w in BENCH["workloads"]:
        cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
        data = spec.config(cfg["name"])
        assert data["reduced"] == cfg["reduced"]
        for kind in ("configs", "reference"):
            assert os.path.isfile(spec.path(kind, cfg["name"], ".py"))
        mix = spec.mix(w["traffic"])
        assert mix["loop"] in ("closed", "open")
        assert os.path.isfile(spec.path("entries", mix["entry"], ".py"))
        assert np.dtype(mix["dtype"]).kind == "c"
        assert spec.limits(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.isfile(spec.path("metrics", m["name"], ".py"))
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def reported(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_each_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in CELLS:
        assert reported(e2e["setup_s"], cell)
        assert sum(reported(m, cell) for m in e2e.values()) >= 2
        assert any(reported(m, cell) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", CELLS):
            assert reported(e2e[m["moves"]], cell), (m["name"], cell)


def test_rooflines_against_hand_counts():
    # K1 at 8^3 with 2 maps on one image: bytes 8 V (2 + 2) + 32 V, flops
    # 2 volumes x (V (20 + 40 + 80) log2 8 + 16 V + 14 V)
    V = 512
    ms, what = bounds.toeplitz_bound((8, 8, 8), 1, 2)
    flops = 2 * (V * 140 * 3 + 30 * V)
    assert what == "bytes"
    assert ms == pytest.approx(1e3 * max(
        (8 * V * 4 + 32 * V) / 3.35e12, flops / 67e12))
    # K2 (no maps) on 2 volumes of 4 x 8 x 16
    V = 4 * 8 * 16
    ms, _ = bounds.toeplitz_bound((4, 8, 16), 2, 0)
    flops = 2 * (V * (20 * 2 + 40 * 3 + 80 * 4) + 16 * V)
    assert ms == pytest.approx(1e3 * max((8 * V * 4 + 32 * V) / 3.35e12,
                                         flops / 67e12))
    # SpMM: 10 nonzeros of a 4 x 6 matrix on 2 real columns
    ms, what = bounds.spmm_bound(10, 4, 6, 2)
    assert what == "bytes"
    assert ms == pytest.approx(1e3 * (80 + 4 * 2 * 10) / 3.35e12)


def test_rooflines_equal_the_programs_at_freezing():
    from indigo_tpu_torch import profiling
    import scipy.sparse as sp
    for shape, S, nc in (((8, 8, 8), 1, 2), ((256, 256, 256), 1, 8),
                         ((16, 24, 8), 3, 0)):
        assert bounds.toeplitz_bound(shape, S, nc) == pytest.approx(
            profiling.toeplitz_bound(shape, S, nc))
    A = sp.random(50, 70, density=0.1, random_state=0, format="csr")
    assert bounds.spmm_bound(A.nnz, 50, 70, 16) == pytest.approx(
        profiling.spmm_bound(A, 16))


def window_metrics(latencies, gap=0.0):
    t, records = 0.0, []
    for i, lat in enumerate(latencies):
        records.append((i % 4, t, t + lat))
        t += lat + gap
    ctx = SimpleNamespace(records=records, window_s=t, setup_s=1.0)
    return {m: spec.module("metrics", m).read(ctx)
            for m in ("recon_per_s", "recon_s_p90")}


def test_rate_and_p90_over_a_window_with_a_stall():
    steady = window_metrics([0.1] * 30)
    stalled = window_metrics([0.1] * 25 + [1.0] * 5)
    assert steady["recon_per_s"] == pytest.approx(10.0)
    assert steady["recon_s_p90"] == pytest.approx(0.1)
    assert stalled["recon_per_s"] == pytest.approx(30 / 7.5)
    assert stalled["recon_s_p90"] == pytest.approx(1.0)


def test_sample_is_uniform_and_seeded():
    picks = []
    for seed in (1, 2):
        s = harness.Sample(3, seed)
        for k in range(100):
            s.offer(k % 4, k)
        picks.append(sorted(o for _, o in s.kept))
    assert len(picks[0]) == 3 and picks[0] != picks[1]
    again = harness.Sample(3, 1)
    for k in range(100):
        again.offer(k % 4, k)
    assert sorted(o for _, o in again.kept) == picks[0]


def drive(mix, service_s, seconds=0.6, seed=11):
    """The window over a fake request path that takes ``service_s``."""
    def fn(y):
        time.sleep(service_s)
        return y
    pool = [np.full(3, k, dtype=np.dtype(mix["dtype"])) for k in range(4)]
    sample = harness.Sample(2, seed)
    return harness.window("call", fn, pool, dict(mix), seed, seconds,
                          sample)


def test_closed_loop_with_clients_queues_them():
    one = {"loop": "closed", "clients": 1, "dtype": "complex64"}
    records, window_s, attempted, failed = drive(one, 0.02)
    lat = sorted(d - h for _, h, d in records)
    assert failed == 0 and attempted == len(records) >= 10
    assert window_s >= 0.6
    # three clients, one server: each request waits for the two ahead
    records, _, attempted, _ = drive(dict(one, clients=3), 0.02)
    lat3 = sorted(d - h for _, h, d in records)
    assert attempted == len(records)
    assert 2.5 <= lat3[len(lat3) // 2] / lat[len(lat) // 2] <= 3.5


def test_open_loop_hands_requests_at_seeded_arrivals():
    mix = {"loop": "open", "rate_per_s": 40.0, "dtype": "complex64"}
    records, window_s, attempted, _ = drive(mix, 0.005, seconds=1.0)
    handed = [h - records[0][1] for _, h, _ in records]
    again, _, _, _ = drive(mix, 0.005, seconds=1.0)
    assert handed == pytest.approx([h - again[0][1] for _, h, _ in again])
    assert 20 <= attempted <= 65 and attempted == len(records)
    # under capacity a request waits little; over it the queue grows
    under = sorted(d - h for _, h, d in records)[len(records) // 2]
    over, _, _, _ = drive(dict(mix, rate_per_s=400.0), 0.005, seconds=0.5)
    lat = [d - h for _, h, d in over]
    assert lat[-1] > 0.1 and lat[-1] > 5 * max(lat[0], under)


def test_the_pool_is_handed_in_the_mixs_dtype():
    system = SimpleNamespace(make_pool=lambda n: [
        np.ones(4, np.complex64) * k for k in range(n)])
    pool = harness.make_pool(system, {"pool": 3, "dtype": "complex128"})
    assert len(pool) == 3 and all(y.dtype == np.complex128 for y in pool)


def summary(by_name, requests=2):
    return {"requests": requests, "by_name": dict(by_name),
            "count_by_name": {k: n for k, (_, n) in by_name.items()}}


def test_k1_roofline_from_the_trace_against_a_hand_count():
    cfg = {"image": [8, 8, 8], "coils": 2, "iters": 3}
    bound_ms, _ = bounds.toeplitz_bound((8, 8, 8), 1, 2)
    kern = {"kern_fwd<16,16,true>": 1e-3, "kern_x<16,16>": 2e-3,
            "kern_inv<16,16,false>": 1e-3, "cublas_gemm": 5.0}
    s = summary({k: (v, 4) for k, v in kern.items()})
    s["by_name"] = kern
    ctx = SimpleNamespace(summary=s, cfg=cfg)
    # 2 requests x 3 CG steps of one image with both coils, over 4 ms
    assert readers.normal_op_roofline(ctx) == pytest.approx(
        100 * 6 * bound_ms / 4.0)
    s["by_name"] = {"cublas_gemm": 5.0}
    assert readers.normal_op_roofline(ctx) is None


def test_spmm_roofline_from_the_trace_against_a_hand_count():
    reader = spec.module("metrics", "spmm_roofline")
    cfg = dict(spec.config("radial2d-256c8"), image=[16, 16], coils=2)
    traj = spec.module("configs", "radial2d-256c8").radial(
        dict(cfg, spokes=8, readout=16))
    nnz, rows, cols = reader.reference_nnz(cfg, traj, "cpu")
    assert rows == len(traj) and cols == 24 * 24
    assert nnz <= rows * cfg["width"] ** 2
    bound_ms, _ = bounds.spmm_bound(nnz, rows, cols, 4)
    s = {"by_name": {"row_spmm<4,true>": 3e-6, "gather": 1.0},
         "count_by_name": {"row_spmm<4,true>": 5, "gather": 9}}
    ctx = SimpleNamespace(summary=s, cfg=cfg, system=SimpleNamespace(
        traj=traj), device="cpu")
    assert reader.read(ctx) == pytest.approx(100 * 5 * bound_ms / 3e-3)


def run_py(cwd, *args, card=False):
    env = dict(os.environ) if card else dict(os.environ,
                                             CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "portbench", "run.py"), *args],
        cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def test_no_card_exits_nonzero_without_a_result():
    r = run_py(spec.ROOT, "--workload", CELLS[0], "--seed", "3000000019",
               "--seconds", "1", "--trace", "0")
    assert r.returncode != 0
    assert not r.stdout.strip()
    assert "no CUDA device" in r.stderr


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = run_py(str(tmp_path), "--workload", CELLS[0], "--seed", "7",
               "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and not r.stdout.strip()


LOADED = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.lib import harness, spec
cell = spec.workload(spec.benchmark(), {cell!r})
harness.run_cell({cell!r}, 4000000007, 0.3, False, device="cpu",
                 overrides={small!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    config = spec.workload(BENCH, cell)["config"]
    code = LOADED.format(root=spec.ROOT, cell=cell, small=SMALL[config])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=spec.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not loaded & set(harness.BANNED), loaded & set(harness.BANNED)
    assert "indigo_tpu_torch" in loaded


REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.lib import spec
cfg = dict(spec.config({config!r}), **{small!r})
system = spec.module("configs", {config!r}).System(cfg, 5, "cpu")
pool = system.make_pool(1)
ref = spec.module("reference", {config!r}).Reference(
    cfg, system.traj, system.maps, "float64", "cpu")
ref.answer(pool[0])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("config", sorted(SMALL))
def test_the_reference_loads_nothing_of_the_program(config):
    code = REFERENCE_ONLY.format(root=spec.ROOT, config=config,
                                 small=SMALL[config])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=spec.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not loaded & (set(harness.BANNED) | {"indigo_tpu_torch"})


NEW_ENTRY = '''"""A throwaway entry: the configuration's request path on a
copy of each request's k-space."""


def entry(system):
    return "call", lambda y: system.serve(y.copy())
'''
# name: (configuration, the cell whose mix and limits it starts from, the
# mix's new numbers, a new entry's code, the control test's size, at which
# the cell's limits hold); the 2D cell is the one held back from
# BENCHMARK.json, whose files stay
NEW_MIXES = {
    "open128": ("kooshball3d-256c8", "interactive",
                {"entry": "pb_copy", "dtype": "complex128", "loop": "open",
                 "rate_per_s": 20.0}, NEW_ENTRY,
                {"image": [24, 24, 24], "coils": 4, "spokes": 384,
                 "readout": 24, "coil_chunk": 2}),
    "two_clients": ("radial2d-256c8", "slices",
                    {"entry": "call", "dtype": "complex64", "loop": "closed",
                     "clients": 2}, None,
                    {"image": [48, 48], "spokes": 72, "readout": 96}),
}
NEW_RUN = """
import json, sys
sys.path[:0] = [{tmp!r}, {root!r}]
from portbench.lib import harness
r = harness.run_cell({cell!r}, 4300000001, 0.3, False, device="cpu",
                     overrides={small!r})
print(json.dumps(r))
"""


def digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.mark.parametrize("name", sorted(NEW_MIXES))
def test_a_new_mix_is_files_of_its_own(tmp_path, name):
    """A cell on a new mix, with a new entry where it needs one, runs from
    added files and a new workload entry alone."""
    shutil.copy(spec.BENCHMARK, tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = digest(tmp_path / "portbench")
    config, base_cell, numbers, code, small = NEW_MIXES[name]
    base = tmp_path / "portbench"
    mix = dict(spec.mix(base_cell), **numbers)
    (base / "mixes" / f"pb_{name}.json").write_text(json.dumps(mix))
    if code:
        (base / "entries" / f"{numbers['entry']}.py").write_text(code)
    cell = f"{config}.pb_{name}"
    shutil.copy(base / "limits" / f"{config}.{base_cell}.json",
                base / "limits" / f"{cell}.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": f"pb_{name}", "chips": 1,
                               "why": "a throwaway cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = NEW_RUN.format(tmp=str(tmp_path), root=spec.ROOT, cell=cell,
                          small=small)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 and result["failed"] == 0
    after = digest(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before


def test_run_seconds_fits_the_check_with_every_cell():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card only")
    r = run_py(spec.ROOT, "--workload", cell, "--seed", "4200000011",
               "--seconds", "3", "--trace", "0", card=True)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
