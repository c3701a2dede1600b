"""Toeplitz SENSE normal op: the port's plain version vs the reference's
Pallas kernel (interpret mode) and its jnp block path.

Tolerances: 2e-4 against the Pallas kernel (its bf16x3 Karatsuba products,
the bar of tests/test_dft_pallas.py); 1e-5 against the f32 jnp block path.
The CUDA kernel itself is checked on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indigo_tpu.ops.dft_pallas import pallas_spectrum, sense_normal_pallas
from indigo_tpu.parallel.recon import sense_normal_batched as j_batched
from indigo_tpu_torch.ops.dft_cuda import (
    kernel_spectrum, sense_normal_cuda, sense_normal_reference, supported)
from indigo_tpu_torch.ops.dft_fft import block_spectrum
from indigo_tpu_torch.parallel.recon import sense_normal_batched
from indigo_tpu_torch.utils import rand64c, rel_err


def _inputs(rng, shape, S=2, nc=2):
    Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(np.float32)
    maps = rand64c(nc, *shape, rng=rng)
    v = rand64c(S, *shape, rng=rng)
    return Tf, maps, v


@pytest.mark.parametrize("shape", [(8, 8, 8), (8, 16, 24), (8, 136, 8)])
def test_reference_matches_pallas_kernel(rng, shape):
    Tf, maps, v = _inputs(rng, shape)
    ref = np.asarray(sense_normal_pallas(
        jnp.asarray(pallas_spectrum(Tf)), jnp.asarray(maps),
        jnp.asarray(v), interpret=True))
    out = sense_normal_reference(torch.from_numpy(kernel_spectrum(Tf)),
                                 torch.from_numpy(maps), torch.from_numpy(v))
    assert rel_err(out, ref) < 2e-4


@pytest.mark.parametrize("shape,coil_chunk", [((8, 16, 24), None),
                                              ((16, 8, 8), 2),
                                              ((12, 20), 1)])
def test_batched_matches_jnp_block(rng, shape, coil_chunk):
    Tf, maps, v = _inputs(rng, shape, S=2, nc=4)
    xs = v.reshape(2, -1)
    ref = np.asarray(j_batched(
        jnp.asarray(block_spectrum(Tf)), jnp.asarray(maps), jnp.asarray(xs),
        coil_chunk=coil_chunk, layout="block"))
    out = sense_normal_batched(
        torch.from_numpy(block_spectrum(Tf)), torch.from_numpy(maps),
        torch.from_numpy(xs), coil_chunk=coil_chunk, layout="block")
    assert rel_err(out, ref) < 1e-5


def test_kernel_layout_on_cpu_takes_plain_path(rng):
    """On CPU tensors the kernel layout runs the plain version (same
    numbers as 'block') and launches nothing."""
    Tf, maps, v = _inputs(rng, (8, 16, 8), S=1, nc=4)
    T = torch.from_numpy(kernel_spectrum(Tf))
    m = torch.from_numpy(maps)
    xs = torch.from_numpy(v.reshape(1, -1))
    before = sense_normal_cuda.launches
    a = sense_normal_batched(T, m, xs, coil_chunk=2, layout="kernel")
    b = sense_normal_batched(T, m, xs, coil_chunk=2, layout="block")
    assert sense_normal_cuda.launches == before
    assert rel_err(a, b) < 1e-6


def test_supported_mirrors_pallas_rule():
    from indigo_tpu.ops.dft_pallas import pallas_supported
    for shape in [(8, 8, 8), (256, 256, 256), (264, 8, 8), (12, 8, 8),
                  (8, 8), (16, 136, 8)]:
        assert supported(shape) == pallas_supported(shape), shape

