"""Each cell's comparison fails what it must fail, at a size the CPU holds.

The control: the plain reference a step below the configuration's
precision (float32 with TF32 products, emulated on the CPU by rounding
every GEMM operand to TF32) put in the program's place. And a whole run of
each cell, the look for a card skipped, with the timed path broken
underneath in each way the cell can break: every CG step returning its
state unchanged, half of the coils (the batch of the normal operator) left
out with the rest counted twice, and the image altered where it is
produced. Each must read ``correct`` false; the unbroken run true. On the
card the control runs at each cell's own size with ``readings.py``.
"""
import numpy as np
import pytest
import torch

from portbench import readings
from portbench.lib import harness, spec

SMALL = {
    "kooshball3d-256c8": {"image": [24, 24, 24], "coils": 4, "spokes": 384,
                          "readout": 24, "coil_chunk": 2},
}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small(cell):
    return SMALL[spec.workload(spec.benchmark(), cell)["config"]]


def failing(checks):
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    checks = readings.control(cell, 4000000007, torch.device("cpu"),
                              small(cell))
    assert failing(checks), checks


def zero_centre(x):
    x = x.clone()
    x.reshape(-1)[x.numel() // 2 - x.numel() // 16:
                  x.numel() // 2 + x.numel() // 16] = 0
    return x


def break_3d(monkeypatch, fault):
    import indigo_tpu_torch.models.recon as recon
    if fault == "state_unchanged":
        cg = recon.batched_cg
        monkeypatch.setattr(recon, "batched_cg",
                            lambda *a, **k: cg(*a, **dict(k, iters=0)))
    elif fault == "half_the_batch":
        normal = recon.sense_normal_batched

        def half(Tf, maps, xs, **k):
            return 2 * normal(Tf, maps[: maps.shape[0] // 2], xs, **k)
        monkeypatch.setattr(recon, "sense_normal_batched", half)
    elif fault == "answer_altered":
        solve = recon.SenseRecon.solve

        def altered(self, b):
            x, r, k = solve(self, b)
            return zero_centre(x), r, k
        monkeypatch.setattr(recon.SenseRecon, "solve", altered)


FAULTS = ["none", "state_unchanged", "half_the_batch", "answer_altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_reads_not_correct(cell, fault, monkeypatch):
    break_3d(monkeypatch, fault)
    result = harness.run_cell(cell, 4100000009, 0.2, False, device="cpu",
                              overrides=small(cell))
    assert result["attempted"] >= 1
    assert result["correct"] is (fault == "none"), result["checks"]
    assert np.isfinite(list(c["value"] for c in result["checks"].values())
                       ).all() or fault != "none"
