"""CUDA kernel tests: they need an NVIDIA GPU with nvcc and skip elsewhere.

This file imports neither jax nor indigo_tpu, so it runs on a GPU machine
without jax, where tests/conftest.py (which imports jax) must be skipped:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -rs

Tolerance 1e-4 against the plain torch version: the kernel accumulates in
f32 FMA in another order than cuBLAS.
"""
import numpy as np
import pytest
import torch

from indigo_tpu_torch.ops.dft_cuda import (
    kernel_spectrum, sense_normal_cuda, sense_normal_reference)
from indigo_tpu_torch.utils import rand64c, rel_err

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc to build the kernel")
    return torch.device("cuda")


def _inputs(rng, shape, S, nc, dev):
    Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(np.float32)
    return (torch.from_numpy(kernel_spectrum(Tf)).to(dev),
            torch.from_numpy(rand64c(nc, *shape, rng=rng)).to(dev),
            torch.from_numpy(rand64c(S, *shape, rng=rng)).to(dev))


@pytest.mark.parametrize("shape,S,nc", [((8, 8, 8), 1, 2),
                                        ((8, 16, 24), 2, 3),
                                        ((16, 136, 8), 1, 2),
                                        ((24, 8, 136), 2, 1)])
def test_kernel_matches_plain(cuda, shape, S, nc):
    T, m, x = _inputs(np.random.default_rng(1), shape, S, nc, cuda)
    before = sense_normal_cuda.launches
    out = sense_normal_cuda(T, m, x)
    torch.cuda.synchronize()
    assert sense_normal_cuda.launches == before + 3
    assert rel_err(out, sense_normal_reference(T, m, x)) < 1e-4


def test_kernel_rejects_what_it_does_not_take(cuda):
    T, m, x = _inputs(np.random.default_rng(2), (8, 8, 8), 1, 2, cuda)
    with pytest.raises(TypeError):
        sense_normal_cuda(T, m.to(torch.complex128), x)
    with pytest.raises(ValueError):
        sense_normal_cuda(T, m, x.transpose(1, 3))
    T2, m2, x2 = _inputs(np.random.default_rng(2), (12, 8, 8), 1, 2, cuda)
    with pytest.raises(ValueError):
        sense_normal_cuda(T2, m2, x2)


def test_recon_kernel_path_matches_cpu_plain_path(cuda):
    from indigo_tpu_torch.models import SenseRecon

    rng = np.random.default_rng(3)
    n, nc = 32, 4
    dirs = rng.standard_normal((256, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = (np.arange(32) - 16) / 32
    traj = (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)
    maps = (0.5 + rand64c(nc, n, n, n, rng=rng) * 0.1).astype(np.complex64)
    kw = dict(oversamp=1.25, width=4, iters=8, coil_chunk=2)
    gpu = SenseRecon(traj, maps, device="cuda", **kw)
    cpu = SenseRecon(traj, maps, device="cpu", **kw)
    assert gpu.layout == "kernel" and cpu.layout == "block"
    y = rand64c(nc * len(traj), rng=rng)
    before = sense_normal_cuda.launches
    xg, rg = gpu(y, return_resids=True)
    assert sense_normal_cuda.launches - before == 3 * 8 * (nc // 2)
    xc, rc = cpu(y, return_resids=True)
    assert rel_err(xg, xc) < 1e-4
    assert rel_err(rg, rc) < 1e-4
