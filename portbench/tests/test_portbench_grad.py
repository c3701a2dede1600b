"""The cell ``kooshball3d-256c8-grad.train`` on the CPU: its files resolve
by name; a small run is correct and loads no ``jax``; its readers against
the recorder filled by the configuration's own request path and against a
hand count; the TF32 control failing its limits; and its timed path,
broken underneath three ways, reading ``correct`` false.

On the CPU the port's normal op and adjoint pad-DFT run their plain
versions; where a test needs the backward that K1 runs on the card, it
routes the plain normal op through ``_SenseNormalFn`` (the Function K1's
launches go through), as ``tests/test_torch_grad_recipe.py`` does.
"""
import json
import math
import os
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
CELL, CONFIG = "kooshball3d-256c8-grad.train", "kooshball3d-256c8-grad"
SMALL = {"image": [24, 24, 24], "coils": 4, "spokes": 384, "readout": 24,
         "coil_chunk": 2}
METRICS = {"solve_ms.train", "backward_ms.train", "solve_bwd_ms.train",
           "rhs_bwd_ms.train", "sense_normal_roofline.train",
           "device_idle_share.train"}
LIMITS = {"img_rel_l2", "img_rel_max", "grad_rel_l2", "grad_rel_max"}


def test_the_grad_cell_resolves_to_its_files():
    w = spec.workload(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "train", 1)
    for kind in ("configs", "reference"):
        assert os.path.isfile(spec.path(kind, CONFIG, ".py"))
    assert spec.limits(CELL).keys() == LIMITS
    e2e = {e["name"] for e, _ in spec.metrics(BENCH, w, False)}
    assert e2e == {"recon_per_s", "recon_s_p90", "setup_s"}
    layer = {e["name"]: m for e, m in spec.metrics(BENCH, w, True)}
    assert set(layer) == METRICS
    for name, mod in layer.items():
        assert mod.__file__ == spec.path("metrics", name, ".py")
    mix = spec.mix("train")
    assert (mix["entry"], mix["dtype"], mix["loop"], mix["clients"],
            mix["pool"], mix["warmup"], mix["sample"], mix["trace"]) == (
        "call", "complex64", "closed", 1, 4, 2, 2, {"skip": 3, "count": 20})


def test_the_grad_configuration_states_the_block():
    cfg, koosh = spec.config(CONFIG), spec.config("kooshball3d-256c8")
    for k in koosh:
        if k not in ("name", "source", "assumed"):
            assert cfg[k] == koosh[k], k
    assert cfg["reduced"] == [] and isinstance(cfg["target_seed"], int)
    assert {"loss", "target", "gradient", "host_copies"} <= set(
        cfg["assumed"])
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert entry["source"] == cfg["source"] and entry["reduced"] == []


RUN = """
import json, sys
sys.path[:0] = [{root!r}]
from portbench.lib import harness
r = harness.run_cell({cell!r}, 4300000001, 0.3, False, device="cpu",
                     overrides={small!r})
r["loaded"] = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(r))
"""


def test_a_small_run_is_correct_and_loads_no_jax():
    code = RUN.format(root=spec.ROOT, cell=CELL, small=SMALL)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=spec.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["checks"].keys() == LIMITS
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert not set(result["loaded"]) & set(harness.BANNED)
    assert "indigo_tpu_torch" in result["loaded"]


def through_the_function(monkeypatch, skip_first_chunk=False):
    """The plain normal op routed through ``_SenseNormalFn``, the first
    coil chunk's backward giving zeros with ``skip_first_chunk``."""
    from indigo_tpu_torch.ops import dft_cuda
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
        skip = skip_first_chunk and maps.storage_offset() == 0
        fn = Skipped if skip else dft_cuda._SenseNormalFn
        return fn.apply(launch, Tf, maps, v)
    routed.cuda_calls = 0   # the plain version's counter
    monkeypatch.setattr(dft_cuda, "sense_normal_reference", routed)


def traced(monkeypatch):
    """The recorder after two traced requests of the configuration at a
    small size on the CPU through the Function route, device ms = host ms
    (the CPU takes no CUDA events)."""
    from indigo_tpu_torch import tracing
    through_the_function(monkeypatch)
    cfg = dict(spec.config(CONFIG), **SMALL)
    system = spec.module("configs", CONFIG).System(cfg, 4100000009, "cpu")
    pool = system.make_pool(2)
    system.build()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for y in pool:
            system.serve(y)
    recs = [s for s in tracing.spans() if s.name != "indigo.init"
            and not s.name.startswith("indigo.init.")]
    tracing.clear()
    for s in recs:
        s.device_ms = s.host_ms
    return cfg, recs


def test_the_readers_read_the_training_path(monkeypatch):
    cfg, recs = traced(monkeypatch)
    monkeypatch.setattr(spans, "records", lambda: recs)
    count = Counter(s.name for s in recs)
    iters, chunks = cfg["iters"], cfg["coils"] // cfg["coil_chunk"]
    assert count == {"indigo.rhs": 2, "indigo.ingress": 2, "indigo.solve": 2,
                     "indigo.cg_iter": 2 * iters,
                     "indigo.normal_op": 2 * (iters + iters * chunks),
                     "indigo.backward": 2, "indigo.solve_bwd": 2,
                     "indigo.rhs_bwd": 2}
    assert len({s.request for s in recs}) == 2
    ctx = SimpleNamespace(summary={"requests": 2}, cfg=cfg)

    def read(name):
        return spec.module("metrics", name).read(ctx)

    def per(name):
        return sum(s.device_ms for s in recs if s.name == name) / 2

    for metric, span in (("solve_ms.train", "indigo.solve"),
                         ("backward_ms.train", "indigo.backward"),
                         ("solve_bwd_ms.train", "indigo.solve_bwd"),
                         ("rhs_bwd_ms.train", "indigo.rhs_bwd")):
        assert read(metric) == pytest.approx(per(span)), metric
    assert per("indigo.solve_bwd") + per("indigo.rhs_bwd") <= per(
        "indigo.backward")
    # without a traced stretch, or without the backward's spans (the
    # program before them), nothing is read
    ctx.summary = None
    assert all(read(m) is None for m in METRICS)
    ctx.summary = {"requests": 2}
    monkeypatch.setattr(spans, "records", lambda: [
        s for s in recs if s.name not in ("indigo.backward",
                                          "indigo.solve_bwd",
                                          "indigo.rhs_bwd")])
    assert all(read(m) is None for m in (
        "backward_ms.train", "solve_bwd_ms.train", "rhs_bwd_ms.train"))
    assert read("solve_ms.train") == pytest.approx(per("indigo.solve"))


def test_the_training_roofline_against_a_hand_count():
    reader = spec.module("metrics", "sense_normal_roofline.train")
    cfg = {"image": [8, 8, 8], "coils": 2, "iters": 3}
    bound_ms, _ = bounds.toeplitz_bound((8, 8, 8), 1, 2)
    # the cell's frozen bound: one image with its 8 coils at 256^3
    ms, what = bounds.toeplitz_bound((256, 256, 256), 1, 8)
    assert what == "operations" and ms == pytest.approx(2.304, abs=5e-4)
    kern = {"kern_fwd<16,16,true>": 1e-3, "kern_x<16,16>": 2e-3,
            "kern_inv<16,16,true>": 1e-3, "cublas_gemm": 5.0}
    s = {"requests": 2, "by_name": kern,
         "count_by_name": dict.fromkeys(kern, 12)}
    # 2 requests x (3 forward + 3 backward) applications over 4 ms of K1
    got = reader.read(SimpleNamespace(summary=s, cfg=cfg))
    assert got == pytest.approx(100 * 2 * 6 * bound_ms / 4.0)
    s["by_name"] = {"cublas_gemm": 5.0}
    assert reader.read(SimpleNamespace(summary=s, cfg=cfg)) is None
    assert reader.read(SimpleNamespace(summary=None, cfg=cfg)) is None
    idle = spec.module("metrics", "device_idle_share.train")
    assert idle.read(SimpleNamespace(summary={
        "busy_s": 0.9, "wall_s": 1.2})) == pytest.approx(25.0)


def test_the_control_fails_the_grad_limits():
    checks = readings.control(CELL, 4000000007, torch.device("cpu"), SMALL)
    assert checks.keys() == LIMITS
    failing = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    assert {"grad_rel_l2", "img_rel_l2"} <= set(failing), checks


def break_grad(monkeypatch, fault):
    import indigo_tpu_torch.models.recon as recon
    if fault == "k1_backward_skipped":
        through_the_function(monkeypatch, skip_first_chunk=True)
    elif fault == "weighted_gradient":
        # the gradient of the weighted samples w y handed back as that of
        # y: the DCF weight left out of the rhs's reverse
        def rhs(self, y):
            ys = self._samples(y).reshape(self.nc, -1)[:, self.perm]
            wy = ys.reshape(-1) + (self.wd * ys.reshape(-1) - ys.reshape(
                -1)).detach()
            return self.A.apply(wy[:, None], adjoint=True).reshape(1, -1)
        monkeypatch.setattr(recon.SenseRecon, "rhs", rhs)
    elif fault == "gradient_scaled":
        samples = recon._BackwardSpans.samples

        def scaled(self, g):
            samples(self, g)
            return 1.01 * g
        monkeypatch.setattr(recon._BackwardSpans, "samples", scaled)


@pytest.mark.parametrize("fault", ["none", "k1_backward_skipped",
                                   "weighted_gradient", "gradient_scaled"])
def test_a_broken_grad_path_reads_not_correct(fault, monkeypatch):
    break_grad(monkeypatch, fault)
    result = harness.run_cell(CELL, 4100000009, 0.2, False, device="cpu",
                              overrides=SMALL)
    assert result["attempted"] >= 1
    assert result["correct"] is (fault == "none"), result["checks"]
    checks = result["checks"]
    assert all(math.isfinite(c["value"]) for c in checks.values())
    if fault != "none":
        # the image is right; the gradient is what fails
        assert checks["img_rel_l2"]["value"] <= checks["img_rel_l2"]["limit"]
        assert checks["grad_rel_l2"]["value"] > checks["grad_rel_l2"]["limit"]


def test_an_output_of_another_length_reads_not_finite():
    ref = spec.module("reference", CONFIG).Reference
    y = np.zeros(8, np.complex64)
    nums = ref.numbers(y, torch.zeros(24, dtype=torch.complex128),
                       np.zeros(16, np.complex64))
    assert set(nums) == LIMITS
    assert all(v == harness.NOT_FINITE for v in nums.values())
