"""The port's profiling against the reference's contract, with the H100's
figures: names, roofline report, differenced timing on the CPU, the
Toeplitz CG-iteration models and the kernel bounds ``chip_smoke.py``
prints (``PERF.md``'s kernel table)."""
import os

import numpy as np
import pytest
import torch

import indigo_tpu as jit_
import indigo_tpu.profiling as jp
import indigo_tpu_torch as tit
import indigo_tpu_torch.profiling as tp
from indigo_tpu_torch.utils import rand64c


def test_names_equal_the_reference():
    assert sorted(tp.__all__) == sorted(jp.__all__)
    assert len(tp.__all__) == 10
    for name in tp.__all__:
        assert hasattr(tp, name), name


def test_h100_constants():
    assert tp.HBM_BYTES_PER_SEC == 3.35e12
    assert tp.MXU_MACS_PER_SEC == 67e12 / 2
    # the card's row gather, far below the TPU's ~8 ns
    assert 0 < tp.GATHER_SEC_PER_ROW < 1e-9


def test_roofline_report(rng):
    d = rand64c(256, rng=rng)
    op = tit.Diag(d, device="cpu")
    result, text = tp.roofline_report(op, ncols=1, measure=True)
    assert result["sol_sec"] > 0 and result["measured_sec"] > 0
    assert "roofline fraction" in text
    assert result["roofline_frac"] == result["sol_sec"] / result[
        "measured_sec"]
    ref, ref_text = jp.roofline_report(jit_.Diag(d), ncols=1, measure=False)
    assert (result["flops"], result["bytes"]) == (ref["flops"], ref["bytes"])
    assert text.splitlines()[:3] == ref_text.splitlines()[:3]
    assert result["sol_sec"] == result["bytes"] / 3.35e12


def test_time_apply(rng):
    assert tp.time_apply(tit.UnscaledFFT((64,)), ncols=1, k1=1, k2=3,
                         device="cpu") > 0
    A = tit.DenseMatrix(rand64c(12, 8, rng=rng), device="cpu")
    assert tp.time_apply(A, ncols=2) > 0          # runs where A lives
    with pytest.raises(ValueError):
        tp.time_apply(A, adjoint_pair=False)
    if not torch.cuda.is_available():   # no tensor, no device: the card
        with pytest.raises((AssertionError, RuntimeError)):
            tp.time_apply(tit.UnscaledFFT((64,)))


def test_measure_hbm_bandwidth_and_trace(tmp_path):
    assert tp.measure_hbm_bandwidth(nbytes=1 << 20, k1=1, k2=3,
                                    device="cpu") > 0
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tp.measure_hbm_bandwidth(nbytes=1 << 10)
    with tp.trace(tmp_path / "t") as prof:
        torch.fft.fft(torch.ones(64, dtype=torch.complex64))
    assert prof is not None
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0


@pytest.mark.parametrize("shape,nc,chunk", [((256,) * 3, 8, None),
                                            ((256,) * 3, 8, 4),
                                            ((64, 48, 32), 3, None)])
def test_cg_iteration_bytes_and_macs(shape, nc, chunk):
    V = int(np.prod(shape))
    nchunks = nc // chunk if chunk else 1
    passes = nchunks * sum(tp.pass_bytes(shape, 1, nc // nchunks))
    want = passes + (6 + 3 * (nchunks - 1)) * V * 8
    assert tp.toeplitz_cg_iter_bytes(shape, nc, "kernel", chunk) == want
    assert tp.toeplitz_cg_iter_bytes(shape, nc, "pallas", chunk) == want
    # the unfused layouts keep the reference's model
    for layout in ("block", "fft"):
        assert tp.toeplitz_cg_iter_bytes(shape, nc, layout, chunk) == \
            jp.toeplitz_cg_iter_bytes(shape, nc, layout, chunk)
    macs = tp.toeplitz_cg_iter_macs(shape, nc)
    ms, _ = tp.toeplitz_bound(shape, 1, nc)
    assert ms >= 2 * macs / 67e12 * 1e3 * (1 - 1e-12)


def test_bounds_print_the_kernel_table():
    """K1 at 256^3 / nc 4, K2 at 256^3 / B 8, K3/K4 on the 256^2 radial
    path's G with 16 real columns: 1.152, 2.276 and 0.0141 ms."""
    from indigo_tpu_torch.models import nufft_op
    from indigo_tpu_torch.operators import SpMatrix
    from indigo_tpu_torch.sparse import jag_to_csr
    n = 256
    k1, k2 = tp.toeplitz_bound((n,) * 3, 1, 4), tp.toeplitz_bound((n,) * 3,
                                                                 8, 0)
    assert (round(k1[0], 3), k1[1]) == (1.152, "operations")
    assert (round(k2[0], 3), k2[1]) == (2.276, "operations")
    ang = np.pi * np.arange(384) / 384
    r = (np.arange(512) - 256) / 512
    traj = np.stack([np.outer(np.cos(ang), r).ravel(),
                     np.outer(np.sin(ang), r).ravel()], axis=1)
    # the radial path's gridding leaf (Morton-tiled columns), as phase 4
    # times it
    A, _ = nufft_op(traj, (n, n), oversamp=1.5, width=4, interp="sparse",
                    device="cpu")
    (leaf,) = [m for m in A.modules() if isinstance(m, SpMatrix)]
    G = jag_to_csr(leaf.ell)
    assert G.shape == (196608, 147456) and G.nnz == 16 * 196608
    ms, by = tp.spmm_bound(G, 16)
    assert (round(ms, 4), by) == (0.0141, "bytes")
    assert tp.bound(3.35e9, 0) == (1.0, "bytes")
    assert tp.bound(0, 67e9) == (1.0, "operations")


def test_tile_adj_floor(rng):
    from indigo_tpu_torch.ops.tile_interp import plan_tile_interp
    traj = rng.random((300, 2)) - 0.5
    plan = plan_tile_interp(traj, (32, 32), width=4)
    floor, terms = tp.tile_adj_floor(plan, 2)
    assert set(terms) == {"rows", "hbm", "flops"}
    assert floor == max(terms.values()) > 0
    assert terms["rows"] == 300 * 16 * tp.GATHER_SEC_PER_ROW
    assert terms["flops"] == 2 * 300 * 16 * 2 / 67e12
