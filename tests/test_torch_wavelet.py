"""``wavelet.DWT`` of the port against the reference's and against the
float64 ``oracle.dwt`` (<= 1e-5, f32 matmuls), and W^H W = I (<= 1e-5)."""
import numpy as np
import pytest
import torch

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu_torch import oracle
from indigo_tpu_torch.convert import operator_from_reference
from indigo_tpu_torch.utils import rand64c, rel_err
from indigo_tpu_torch.wavelet import WAVELETS, _analysis_matrix

TOL = 1e-5
CASES = [((16, 16), "haar", 2), ((16, 32), "db2", 2), ((32, 32), "db4", 2),
         ((8, 16, 8), "haar", 1), ((16, 8, 16), "db2", 2),
         ((32, 16, 32), "db4", 1), ((64,), "db4", 3)]


@pytest.mark.parametrize("shape,wavelet,levels", CASES)
def test_dwt_matches_reference_and_oracle(rng, shape, wavelet, levels):
    n = int(np.prod(shape))
    W = tit.DWT(shape, wavelet=wavelet, levels=levels, device="cpu")
    ref = jit_.DWT(shape, wavelet=wavelet, levels=levels)
    x = rand64c(n, 2, rng=rng)
    fwd, adj = W * x, W.H * x
    assert rel_err(fwd, np.asarray(ref * x)) < TOL
    assert rel_err(adj, np.asarray(ref.H * x)) < TOL
    assert rel_err(fwd, oracle.dwt(x, shape, wavelet, levels)) < TOL
    assert rel_err(adj, oracle.dwt(x, shape, wavelet, levels,
                                   adjoint=True)) < TOL
    assert rel_err(W.H * fwd, x) < TOL          # W^H W = I
    assert rel_err(W * adj, x) < TOL            # W W^H = I
    conv = operator_from_reference(ref, device="cpu")
    assert torch.equal(conv * x, fwd)


def test_dwt_defaults_real_input_and_errors(rng):
    W, ref = tit.DWT((32, 32), device="cpu"), jit_.DWT((32, 32))
    assert W.levels == ref._levels == 3
    assert W._describe().split(" ")[0] == ref._describe().split(" ")[0]
    xr = rng.standard_normal((1024, 1)).astype(np.float32)
    out = W * torch.from_numpy(xr)
    assert out.dtype == torch.float32
    assert rel_err(out, oracle.dwt(xr, (32, 32), "db4", 3).real) < TOL
    x = torch.from_numpy(rand64c(1024, 1, rng=rng))
    keep = x.clone()
    W * x, W.H * x
    assert torch.equal(x, keep)                 # the input is not written
    with pytest.raises(ValueError):
        tit.DWT((12, 12), levels=3, device="cpu")
    with pytest.raises(ValueError):
        tit.DWT((8, 8), "db4", levels=2, device="cpu")
    assert len(list(W.buffers())) == 3 * 2


def test_filters_are_the_reference_filters():
    from indigo_tpu import wavelet as jw
    assert sorted(WAVELETS) == sorted(jw.WAVELETS)
    for k in WAVELETS:
        np.testing.assert_array_equal(WAVELETS[k], jw.WAVELETS[k])
        np.testing.assert_array_equal(_analysis_matrix(16, WAVELETS[k]),
                                      jw._analysis_matrix(16, jw.WAVELETS[k]))
