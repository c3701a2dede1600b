"""Toeplitz-embedded NUFFT normal operator: its spectrum and its operator.

Counterpart of ``indigo_tpu/toeplitz.py`` (``toeplitz_kernel``,
``ToeplitzNormal``, ``sense_normal_toeplitz``):

    A^H A x  ~=  crop( IFFT( T * FFT( pad_2x(x) ) ) )

T is the real spectrum of the point-spread kernel on the doubled grid,
computed once as the gridded adjoint NUFFT of the weights on a 2N image.
``ToeplitzNormal`` is the operator-algebra leaf that applies it; on the GPU
its 3D form runs the hand-written CUDA kernel K2 (``ops.dft_cuda``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import tracing
from .operators import Diag, KronI, Operator, Perm, VStack
from .utils import as_tensor, common_device, default_device

__all__ = ["toeplitz_kernel", "ToeplitzNormal", "sense_normal_toeplitz"]


def toeplitz_kernel(traj, img_shape, oversamp=1.5, width=5, weights=None,
                    psd_clip=False, return_info=False, warn=True,
                    impl="auto", device=None):
    """Real spectrum T (2N grid, float32 numpy) of the normal-operator kernel.

    Same contract as the reference: ``psd_clip`` clips negative spectrum
    values, ``return_info`` adds ``min``/``max``/``clipped`` diagnostics,
    ``warn`` prints a hint for meaningfully indefinite kernels.

    ``impl``: 'host' is the numpy/scipy build; 'device' runs the adjoint
    gridding (torch ``index_add_``) and the FFTs (``torch.fft``) on
    ``device``; 'auto' picks 'device' when ``device`` is a CUDA device and
    the doubled oversampled grid is large (>= 64^3), else 'host'.
    ``device=None`` is the card (an error where there is none), as the
    reference takes its device path whenever an accelerator is up;
    ``device="cpu"`` asks for the host. An explicit ``impl="host"`` needs
    no device.
    """
    from .noncart import beatty_beta

    img_shape = tuple(int(s) for s in img_shape)
    big = tuple(2 * s for s in img_shape)
    grid2 = tuple(int(2 * round(s * oversamp / 2)) for s in big)
    beta = beatty_beta(width, oversamp)
    M = len(np.atleast_2d(traj))
    w = np.ones(M, np.complex64) if weights is None else \
        np.asarray(weights, np.complex64).ravel()
    if impl != "host":
        device = default_device(device)
    if impl == "auto":
        impl = "device" if (device.type == "cuda"
                            and np.prod(grid2) >= 64 ** 3) else "host"
    if impl == "device":
        Tf = _toeplitz_kernel_device(traj, big, grid2, width, beta, w,
                                     device)
    elif impl == "host":
        Tf = _toeplitz_kernel_host(traj, big, grid2, width, beta, w)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    tmin = float(Tf.min())
    tmax = float(np.abs(Tf).max())
    clipped = False
    if psd_clip:
        Tf = np.maximum(Tf, 0.0)
        clipped = tmin < 0
    elif warn and tmin < -1e-3 * tmax:
        import sys
        print(f"[indigo_tpu_torch.toeplitz] kernel spectrum has negative "
              f"values (min {tmin:.3e}); CG on K + lamda*I is stable for "
              f"lamda > {-tmin:.3e} (SenseRecon applies this floor), or "
              f"pass psd_clip=True", file=sys.stderr)
    Tf = np.ascontiguousarray(Tf)
    if return_info:
        return Tf, {"min": tmin, "max": tmax, "clipped": clipped}
    return Tf


def _toeplitz_kernel_host(traj, big, grid2, width, beta, w):
    """numpy/scipy kernel build (the executable spec)."""
    from .noncart import interp_mat, deapodization

    import scipy.fft as sfft  # keeps complex64 (numpy.fft upcasts)

    G = interp_mat(traj, grid2, width=width, beta=beta)
    v = np.asarray(G.conj().T @ w).reshape(grid2).astype(np.complex64)
    # Fc^H = fftshift . (prod(grid2) * ifftn) . ifftshift
    u = np.fft.fftshift(
        sfft.ifftn(np.fft.ifftshift(v), workers=-1)) * np.float32(
            np.prod(grid2))
    offs = [(g - b) // 2 for b, g in zip(big, grid2)]
    sl = tuple(slice(o, o + b) for b, o in zip(big, offs))
    t = (u[sl] * deapodization(big, grid2, width=width, beta=beta)
         ).astype(np.complex64)
    return sfft.fftn(np.fft.ifftshift(t), workers=-1).real.astype(np.float32)


def _toeplitz_kernel_device(traj, big, grid2, width, beta, w, device):
    """Same math as the host build: torch adjoint gridding + torch.fft.

    At 256^3 the doubled oversampled grid is 640^3 (2.1 GB complex64); the
    host build takes minutes there.
    """
    from .noncart import deapodization
    from .ops.tile_interp import kb_patches, kb_scatter, plan_tile_interp

    plan = plan_tile_interp(traj, grid2, width=width, beta=beta)
    corner, wkb = kb_patches(plan)
    corner = torch.from_numpy(corner).to(device)
    wkb = torch.from_numpy(wkb).to(device)
    y = torch.from_numpy(w[:, None]).to(device)
    v = kb_scatter(corner, wkb, grid2, y)[0]
    del corner, wkb, y
    dims = tuple(range(len(grid2)))
    v = torch.fft.ifftshift(v, dim=dims)
    u = torch.fft.fftshift(torch.fft.ifftn(v, dim=dims), dim=dims)
    del v
    u = u * np.float32(np.prod(grid2))
    offs = [(g - b) // 2 for b, g in zip(big, grid2)]
    sl = tuple(slice(o, o + b) for b, o in zip(big, offs))
    da = torch.from_numpy(deapodization(big, grid2, width=width,
                                        beta=beta)).to(device)
    t = u[sl] * da
    del u
    t = torch.fft.ifftshift(t, dim=dims)
    Tf = torch.fft.fftn(t, dim=dims).real.to(torch.float32)
    return np.ascontiguousarray(Tf.cpu().numpy())


class ToeplitzNormal(Operator):
    """Self-adjoint operator x -> crop(IFFT(T * FFT(pad(x)))), shape (N, N).

    ``method`` keeps the reference's names:
      "pallas" — the hand-written kernel family: K2 (``ops.dft_cuda.
        toeplitz_apply_cuda``) on CUDA tensors, its plain version on CPU
        tensors; 3D volumes that ``ops.dft_cuda.supported`` takes;
      "dft"    — the plain matmul-DFT pipeline (``ops/dft_fft.py``), any
        rank, any device;
      "fft"    — the per-axis ``torch.fft`` path (``ops/toeplitz_fft.py``),
        kept as a cross-check;
      "auto"   — "pallas" for volumes the kernel takes, else "dft".
    Unlike the reference, which resolves "auto" by platform when it is
    built, the device is decided by the input tensor at apply time: the
    module moves with ``.to()``, and a CPU tensor never launches a kernel.

    ``Tf`` is the raw spectrum (numpy or a tensor, 2x the image shape).
    "pallas" and "dft" store it in ``kernel_spectrum`` order (the same
    array as ``block_spectrum``), "fft" as it is; the buffer is ``T``, on
    ``device``: by default the card for a numpy ``Tf`` (an error where
    there is none) and ``Tf``'s own device for a tensor.
    """

    def __init__(self, Tf, img_shape, name=None, method="auto",
                 device=None):
        from .ops.dft_cuda import kernel_spectrum, supported

        super().__init__(name)
        if method not in ("auto", "pallas", "dft", "fft"):
            raise ValueError(f"unknown method {method!r}")
        self._vol = tuple(int(s) for s in img_shape)
        if method == "auto":
            method = "pallas" if supported(self._vol) else "dft"
        if method == "pallas" and not supported(self._vol):
            raise ValueError(
                "the pallas method needs a 3D volume with dims that are "
                f"multiples of 8 in [8, 256], got {self._vol}")
        if torch.is_tensor(Tf):
            device = Tf.device if device is None else device
            Tf = Tf.detach().cpu().numpy()
        Tf = np.asarray(Tf, dtype=np.float32)
        if Tf.shape != tuple(2 * s for s in self._vol):
            raise ValueError(f"Tf shape {Tf.shape} is not 2x {self._vol}")
        if method != "fft":
            Tf = kernel_spectrum(Tf)  # host-side, once
        self.register_buffer("T", as_tensor(np.ascontiguousarray(Tf),
                                            device))
        self._method = method

    @property
    def method(self):
        return self._method

    @property
    def img_shape(self):
        return self._vol

    @property
    def shape(self):
        n = int(np.prod(self._vol))
        return (n, n)

    @property
    def dtype(self):
        return torch.complex64

    def apply(self, x, adjoint=False):
        # self-adjoint: forward == adjoint
        from .ops.dft_cuda import toeplitz_apply_cuda
        from .ops.dft_fft import toeplitz_apply_block
        from .ops.toeplitz_fft import fft_pad2x, ifft_crop2x

        K = x.shape[1]
        with tracing.span("indigo.toeplitz", K=K, method=self._method):
            v = x.reshape(self._vol + (K,)).to(torch.complex64)
            if self._method == "fft":
                axes = tuple(range(len(self._vol)))
                v = ifft_crop2x(self.T[..., None] * fft_pad2x(v, axes), axes)
            else:
                # (K, *vol), batch leading; the kernel takes contiguous
                # input only, so the copy is made here, in the open
                v = v.movedim(-1, 0).contiguous()
                if self._method == "pallas":
                    v = toeplitz_apply_cuda(self.T, v)
                else:
                    v = toeplitz_apply_block(self.T, v)
                v = v.movedim(0, -1)
            return v.reshape(-1, K)

    def cost(self, ncols=1):
        K = ncols
        big = int(np.prod(self.T.shape))
        flops = 5 * big * max(1, int(np.log2(max(big, 2)))) * K * 4
        # zero-aware padded round trip: ~(2+4+8)/8 passes of big + T read
        return flops, int(1.75 * big * K * 8 * 2) + big * 4

    def _describe(self):
        return (f"{self.name}{list(self._vol)} <{self.shape[0]}x"
                f"{self.shape[1]}> (2x-grid {list(self.T.shape)})")

    def extra_repr(self):
        return self._describe()

    def sigma_basis(self):
        """(K_sigma, P) with K == P.H * K_sigma * P, as the reference.

        On the "pallas" method of a volume with radix (> 128) axes
        (``ops.dft_cuda.uses_sigma_basis``), P is the ``Perm`` that takes
        natural order to the sigma basis (even | odd blocks on each such
        axis) and K_sigma = P K P^H shares this operator's spectrum:

            Ks, P = K.sigma_basis()
            x, info = cg(Ks, P * b, ...)
            x = P.H * x

        Elsewhere it returns (self, None). The reference's kernels work in
        the sigma basis and K_sigma saves it a reorder per apply; the CUDA
        kernel works in natural order, so here K_sigma is the product
        P * K * P.H (two gathers of the volume per apply). The pair exists
        so that solver code written for the reference runs unchanged and
        gives the same answers.
        """
        from .ops.dft_cuda import _sigma_axes, to_sigma_basis

        axes = _sigma_axes(self._vol) if self._method == "pallas" else ()
        if not axes:
            return self, None
        n = int(np.prod(self._vol))
        idx = to_sigma_basis(torch.arange(n).reshape(self._vol), axes)
        P = Perm(idx.ravel(), name="SigmaBasis", device=self.T.device)
        return P * self * P.H, P


def sense_normal_toeplitz(Tf, maps, device=None):
    """A^H A for multi-coil SENSE via the Toeplitz kernel:
    sum_c Diag(m_c)^H . Toep . Diag(m_c) as an operator tree. ``KronI``
    folds the coils into the column batch, so one ToeplitzNormal apply (one
    K2 launch triple on the GPU) serves every coil.

    ``Tf`` and ``maps`` (nc, *img): numpy (narrowed, maps to complex64) or
    tensors. The operator lives on ``device``, by default the device of the
    tensors given, else the card (``utils.common_device``: an error where
    there is none; tensors on two devices raise rather than move)."""
    dev = common_device(Tf, maps, device=device)
    maps = as_tensor(maps, dev, dtype=torch.complex64)
    nc = maps.shape[0]
    img_shape = tuple(maps.shape[1:])
    T = ToeplitzNormal(Tf, img_shape, name="Toeplitz", device=dev)
    coils = VStack([Diag(maps[c].reshape(-1), name=f"Map{c}")
                    for c in range(nc)], name="Coils")
    return coils.H * KronI(nc, T, name="PerCoil") * coils
