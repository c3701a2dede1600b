"""Batched SENSE normal op and solver: the port vs the reference on the
same raw spectrum, maps and images.

``sense_normal_batched`` with no ``layout`` takes the raw spectrum that
``toeplitz_kernel`` returns, in both packages (the reference's default is
``layout="raw"``). Tolerances: 1e-5 for the normal op (f32 matmul-DFT or
FFT stages summed in another order); 1e-4 for ``sense_batch_recon``
(rounding differences grow over the CG iterations), as in
tests/test_parallel.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indigo_tpu.parallel.recon import sense_batch_recon as j_batch_recon
from indigo_tpu.parallel.recon import sense_normal_batched as j_batched
from indigo_tpu.toeplitz import toeplitz_kernel as j_toeplitz_kernel
from indigo_tpu_torch.parallel.recon import sense_normal_batched
from indigo_tpu_torch.utils import rand64c, rel_err


def _inputs(rng, shape, S=2, nc=4):
    Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(np.float32)
    return Tf, rand64c(nc, *shape, rng=rng), rand64c(S, int(np.prod(shape)),
                                                     rng=rng)


def _port(Tf, maps, xs, **kw):
    return sense_normal_batched(torch.from_numpy(Tf), torch.from_numpy(maps),
                                torch.from_numpy(xs), **kw)


@pytest.mark.parametrize("coil_chunk", [None, 2])
@pytest.mark.parametrize("shape", [(8, 16, 24), (12, 20)])
def test_default_layout_takes_raw_spectrum(rng, shape, coil_chunk):
    Tf, maps, xs = _inputs(rng, shape)
    ref = np.asarray(j_batched(jnp.asarray(Tf), jnp.asarray(maps),
                               jnp.asarray(xs), coil_chunk=coil_chunk))
    out = _port(Tf, maps, xs, coil_chunk=coil_chunk)
    assert rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("shape", [(8, 16, 24), (12, 20)])
def test_fft_layout_matches_reference(rng, shape):
    Tf, maps, xs = _inputs(rng, shape)
    ref = np.asarray(j_batched(jnp.asarray(Tf), jnp.asarray(maps),
                               jnp.asarray(xs), layout="fft"))
    out = _port(Tf, maps, xs, layout="fft")
    assert rel_err(out, ref) < 1e-5
    assert rel_err(out, _port(Tf, maps, xs)) < 1e-5


def test_raw_and_block_layouts_agree(rng):
    from indigo_tpu_torch.ops.dft_fft import block_spectrum

    Tf, maps, xs = _inputs(rng, (8, 8, 16))
    a = _port(Tf, maps, xs, layout="raw")
    b = _port(block_spectrum(Tf), maps, xs, layout="block")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the reference's name for its fused-kernel layout is a synonym of
    # "kernel" (block-order spectrum); an unknown layout still raises
    c = _port(block_spectrum(Tf), maps, xs, layout="pallas", sigma=False)
    np.testing.assert_array_equal(c.numpy(), b.numpy())
    with pytest.raises(ValueError):
        _port(Tf, maps, xs, layout="nope")


def _recon_problem(rng):
    n, nc = 16, 2
    img = (n, n, n)
    traj = rng.random((200, 3)) - 0.5
    maps = rand64c(nc, *img, rng=rng)
    Tf = j_toeplitz_kernel(traj, img, oversamp=2.0, width=6)
    lam = 0.05 * float(np.abs(Tf).max())
    rhs = rand64c(1, int(np.prod(img)), rng=rng)
    return Tf, maps, rhs, lam


@pytest.mark.parametrize("coil_chunk", [None, 1])
def test_sense_batch_recon_matches_reference(rng, coil_chunk):
    from indigo_tpu_torch.parallel.recon import sense_batch_recon

    Tf, maps, rhs, lam = _recon_problem(rng)
    xr, rr = j_batch_recon(Tf, maps, rhs, mesh=None, lamda=lam, iters=12,
                           coil_chunk=coil_chunk)
    xp, rp = sense_batch_recon(Tf, maps, rhs, mesh=None, lamda=lam,
                               iters=12, coil_chunk=coil_chunk, device="cpu")
    assert xp.shape == (1, rhs.shape[1]) and rp.shape == (12, 1)
    assert rel_err(xp, np.asarray(xr)) < 1e-4
    assert rel_err(rp, np.asarray(rr)) < 1e-4


def test_sense_batch_recon_mesh_solves(rng, tmp_path):
    """The call that used to raise now solves: a one-rank gloo group in this
    process, a (1, 1) mesh, the same answer as mesh=None and as the
    reference (the 8-rank meshes are tests/test_torch_parallel.py's)."""
    import torch.distributed as dist
    from indigo_tpu_torch.parallel import make_mesh
    from indigo_tpu_torch.parallel.recon import sense_batch_recon

    Tf, maps, rhs, lam = _recon_problem(rng)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu", slice=1, coil=1)
        xm, rm = sense_batch_recon(Tf, maps, rhs, mesh=mesh, lamda=lam,
                                   iters=12, device="cpu")
    finally:
        dist.destroy_process_group()
    x0, r0 = sense_batch_recon(Tf, maps, rhs, mesh=None, lamda=lam, iters=12,
                               device="cpu")
    xr, _ = j_batch_recon(Tf, maps, rhs, mesh=None, lamda=lam, iters=12)
    assert xm.shape == (1, rhs.shape[1]) and rm.shape == (12, 1)
    assert torch.equal(xm, x0) and torch.equal(rm, r0)
    assert rel_err(xm, np.asarray(xr)) < 1e-4
