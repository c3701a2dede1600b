"""End-to-end SENSE reconstruction pipeline (the serving layer).

Counterpart of ``indigo_tpu/models/recon.py``: build the geometry once
(gridding plan, Toeplitz spectrum, DCF), keep the payloads on the device,
then reconstruct many acquisitions.

    recon = SenseRecon(traj, maps, lamda=1e-2, iters=30, device="cuda")
    img = recon(y)            # y in the user's sample order, coil-major

All public inputs/outputs are in the USER's trajectory order.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from ..ops.dft_cuda import kernel_serves
from ..ops.dft_fft import block_spectrum
from .. import tracing
from ..parallel.recon import sense_normal_batched, batched_cg
from ..toeplitz import toeplitz_kernel
from ..utils import NARROW
from .sense import sense_nufft_op

__all__ = ["SenseRecon"]


def _jacobi(Tf, maps, lamda):
    """diag(normal op + lamda I) = mean(Tf) * sum_c |m_c|^2 + lamda,
    inverted (flat float32)."""
    dg = float(np.mean(Tf)) * np.sum(np.abs(maps) ** 2, axis=0) + lamda
    return (1.0 / np.maximum(dg, 1e-30)).astype(np.float32).ravel()


def host_copy(x):
    """Enqueue the copy of tensor ``x`` to host memory; ``host_array`` of the
    result waits for it and gives the numpy array; the copy carries no
    graph (``x.detach()``). From a CUDA tensor the copy lands in
    page-locked memory from torch's caching host allocator
    (``non_blocking``, then an event on the stream that copies: the current
    stream of ``x``'s card, whichever card is current); the array owns that
    block, which goes back to torch's pinned cache when the caller drops
    it, and the cache keeps it for later copies. From a CPU tensor the
    array is the tensor's own memory. Each copy counts once, in
    ``host_copy.pinned_copies`` or in ``host_copy.pageable_copies``."""
    x = x.detach()
    if x.device.type == "cuda":
        host_copy.pinned_copies += 1
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        return buf, ev
    host_copy.pageable_copies += 1
    return x.cpu(), None


host_copy.pinned_copies = 0
host_copy.pageable_copies = 0


def host_array(pending):
    """The numpy array of a ``host_copy``, once its copy has landed."""
    buf, ev = pending
    if ev is not None:
        ev.synchronize()
    return buf.numpy()


class _BackwardSpans:
    """The spans of one request's backward, opened and closed by hooks on
    the tensors of the graph its forward built: the image's cotangent
    entering opens ``indigo.backward`` and ``indigo.solve_bwd``; the rhs's
    gradient closes the solve's and opens ``indigo.rhs_bwd``; the k-space
    gradient closes both. Every span carries the forward's request id,
    whichever thread runs the backward. While the forward runs,
    ``saved_tensors_hooks(self.pack, self.unpack)`` sums the storages
    autograd saves for the graph, the pipeline's own buffers left out:
    ``indigo.backward``'s attr ``saved_bytes``."""

    def __init__(self, rid, buffers):
        self.rid, self.open, self.saved = rid, [], {}
        self.keep = {b.untyped_storage().data_ptr() for b in buffers}

    def pack(self, t):
        """Count ``t``'s storage; keep ``t`` without its graph. A saved
        output comes with its own node as ``grad_fn``: kept so, it would
        hold that node in a cycle that outlives the request where the
        backward never runs the node (CG's residual history)."""
        st = t.untyped_storage()
        if st.data_ptr() not in self.keep:
            self.saved[st.data_ptr()] = st.nbytes()
        return t.detach()

    @staticmethod
    def unpack(t):
        return t

    def solve(self, rec, y):
        """``rec.solve(rec.rhs(y))`` with the hooks on its graph: on a view
        of y, on the rhs and on the image."""
        y = y.view_as(y)
        y.register_hook(self.samples)
        with torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                      self.unpack):
            b = rec.rhs(y)
            b.register_hook(self.rhs)
            x, resids, k = rec.solve(b)
        x.register_hook(self.image)
        return x, resids, k

    def _enter(self, name, **attrs):
        ctx = tracing.span(name, **attrs)
        sp = ctx.__enter__()
        if sp is not None:
            sp.request = self.rid
        self.open.append(ctx)

    def _exit(self):
        self.open.pop().__exit__(None, None, None)

    def image(self, g):
        self._enter("indigo.backward", saved_bytes=sum(self.saved.values()))
        self._enter("indigo.solve_bwd")

    def rhs(self, g):
        self._exit()
        self._enter("indigo.rhs_bwd")

    def samples(self, g):
        self._exit()
        self._exit()


class SenseRecon(nn.Module):
    """Multi-coil NUFFT SENSE reconstruction pipeline.

    traj: (M, d) in cycles/pixel [-0.5, 0.5); maps: (nc, *img_shape).
    dcf: None | 'radial' (analytic |k|^(d-1) ramp) | 'pipe_menon'
    (``noncart.pipe_menon_dcf`` on the oversampled grid; its fixed point
    runs on ``device`` when that is CUDA and the grid is >= 64^3) | (M,)
    weights in user order — folded into the normal equations
    (A^H W A x = A^H W y). The CG runs on the Toeplitz-embedded normal
    operator; the gridded operator serves ``simulate`` and the rhs.

    lamda: None picks 1e-3 * |Tf|_max floored at the gridding-error
    stability scale (``lamda_floor``); an explicit value is used verbatim,
    with a warning below the floor. tol: 0 runs exactly ``iters`` CG steps;
    > 0 freezes the solve once ||r|| <= tol*||b|| and ``last_iters`` reports
    the count taken. precond: None or 'jacobi'. coil_chunk: coils per
    normal-op call. device: where the payloads live and the solve runs;
    the card by default, as the reference runs on its accelerator (without
    one, building the pipeline raises where torch does; pass "cpu" to run
    on the host). Where ``ops.dft_cuda.kernel_serves`` (a CUDA device, a
    3D volume the kernel takes) the normal op runs the CUDA kernel
    (``layout == "kernel"``); everything else runs the plain torch pipeline
    (``"block"``), on the same block-order spectrum.
    """

    def __init__(self, traj, maps, oversamp=1.25, width=4, lamda=None,
                 iters=30, tol=0.0, precond=None, dcf="radial",
                 coil_chunk=None, device="cuda"):
        super().__init__()
        with tracing.span("indigo.init", setup=True):
            traj = np.atleast_2d(np.asarray(traj, dtype=np.float64))
            maps = np.asarray(maps, dtype=np.complex64)
            img_shape = maps.shape[1:]
            d = traj.shape[1]
            with tracing.span("indigo.init.dcf", setup=True):
                if dcf is None:
                    w = np.ones(len(traj), np.float32)
                elif isinstance(dcf, str) and dcf == "radial":
                    w = (np.sum(traj ** 2, axis=1) ** ((d - 1) / 2.0)
                         + (0.5 / max(img_shape)) ** (d - 1)
                         ).astype(np.float32)
                    w /= w.max()
                elif isinstance(dcf, str) and dcf == "pipe_menon":
                    from ..noncart import pipe_menon_dcf
                    grid = tuple(int(2 * round(s * oversamp / 2))
                                 for s in img_shape)
                    w = pipe_menon_dcf(traj, grid, width=width,
                                       device=device)
                else:
                    w = np.asarray(dcf, np.float32).ravel()
            with tracing.span("indigo.init.plan", setup=True):
                A, plan = sense_nufft_op(traj, maps, oversamp=oversamp,
                                         width=width, device=device)
                w_sorted = np.tile(w[plan.perm], maps.shape[0]).astype(
                    np.float32)
            with tracing.span("indigo.init.toeplitz", setup=True):
                Tf, self.kernel_info = toeplitz_kernel(
                    traj, img_shape, oversamp=oversamp, width=width,
                    weights=w, return_info=True, warn=False, device=device)
            # Stability floor: the restricted Toeplitz operator is PSD up to
            # gridding error, of order the KB aliasing amplitude
            # 10^(1-width) (3x worse below 1.25x oversampling); the default
            # lamda is floored there, an explicit one is kept and warned
            # about.
            eps = 10.0 ** (1 - width) * (3.0 if oversamp < 1.25 else 1.0)
            self.lamda_floor = eps * self.kernel_info["max"]
            if lamda is None:
                lamda = max(1e-3 * self.kernel_info["max"],
                            self.lamda_floor)
            elif lamda < self.lamda_floor:
                warnings.warn(
                    f"SenseRecon: lamda={lamda:.3g} is below the "
                    f"gridding-error stability floor "
                    f"{self.lamda_floor:.3g} (kernel width={width}, "
                    f"oversamp={oversamp}); CG may converge slowly or stall "
                    f"on the indefinite part of the Toeplitz spectrum.",
                    stacklevel=2)
            self._setup(A, plan, Tf, maps, w_sorted, lamda, iters, tol,
                        precond, coil_chunk, device)

    @classmethod
    def from_arrays(cls, state, device="cuda", precond=None, tol=0.0,
                    coil_chunk=None):
        """Build the pipeline from a state of numpy arrays (see
        ``convert.state_from_reference_arrays``) without recomputing any
        geometry — the port's way of loading the reference pipeline's
        weights."""
        with tracing.span("indigo.init", setup=True):
            from ..operators import Diag, KronI, VStack
            from ..ops.tile_interp import TileInterpPlan
            from .sense import NufftPlan, gridding_core

            maps = np.asarray(state["maps"], np.complex64)
            nc, img_shape = maps.shape[0], tuple(maps.shape[1:])
            tplan = TileInterpPlan(
                state["tid"], state["wfac"], state["grid_shape"],
                state["tile"], state["ext"], state["nt"], state["pad_lo"],
                state["width"])
            deapod = np.asarray(state["deapod"], np.float32)
            coils = VStack(
                [Diag((deapod * maps[c]).ravel().astype(np.complex64),
                      name=f"Map{c}", device=device) for c in range(nc)],
                name="Coils")
            A = KronI(nc, gridding_core(tplan, img_shape, device),
                      name="PerCoil") * coils
            plan = NufftPlan(img_shape, tplan.grid_shape, None, tplan.width,
                             None, np.asarray(state["perm"], np.int64), None,
                             deapod=deapod)
            obj = cls.__new__(cls)
            nn.Module.__init__(obj)
            obj.kernel_info = None
            obj.lamda_floor = None
            obj._setup(A, plan, np.asarray(state["Tf"], np.float32), maps,
                       np.asarray(state["w_sorted"], np.float32),
                       float(state["lamda"]), int(state["iters"]), tol,
                       precond, coil_chunk, device)
        return obj

    def _setup(self, A, plan, Tf, maps, w_sorted, lamda, iters, tol,
               precond, coil_chunk, device):
        with tracing.span("indigo.init.setup", setup=True):
            self.device = torch.device(device)
            self.nc = maps.shape[0]
            self.img_shape = tuple(maps.shape[1:])
            self.lamda = float(lamda)
            self.iters = int(iters)
            self.tol = float(tol)
            self.coil_chunk = coil_chunk
            self._last_k = None
            self._request = 0
            self.A = A
            self.plan = plan
            self.layout = ("kernel" if kernel_serves(self.img_shape,
                                                     self.device)
                           else "block")
            self.register_buffer("Tf", torch.from_numpy(block_spectrum(Tf)))
            self.register_buffer("maps", torch.from_numpy(maps))
            self.register_buffer("wd", torch.from_numpy(w_sorted))
            perm = np.asarray(plan.perm, np.int64)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            self.register_buffer("perm", torch.from_numpy(perm))
            self.register_buffer("inv_perm", torch.from_numpy(inv))
            if precond == "jacobi":
                pd = torch.from_numpy(_jacobi(Tf, maps, self.lamda))
            elif precond is None:
                pd = None
            else:
                raise ValueError(f"unknown precond {precond!r}")
            self.register_buffer("pd", pd)
            self.to(self.device)

    @property
    def n_samples(self):
        return self.plan.n_samples

    def _samples(self, y):
        """User-order k-space (numpy or tensor) -> flat complex64 tensor on
        the pipeline's device. 64-bit host data is narrowed on the host
        (``indigo.narrow``), so only complex64 crosses to the card."""
        with tracing.span("indigo.ingress",
                          bytes=8 * self.nc * self.n_samples):
            if isinstance(y, torch.Tensor):
                y = y.to(self.device, torch.complex64).reshape(-1)
            else:
                y = np.asarray(y).reshape(-1)
                if y.dtype in NARROW:
                    with tracing.span("indigo.narrow", bytes=y.nbytes):
                        y = y.astype(np.complex64)
                y = torch.from_numpy(np.ascontiguousarray(
                    y, dtype=np.complex64)).to(self.device)
        if y.shape[0] != self.nc * self.n_samples:
            raise ValueError(f"expected {self.nc}x{self.n_samples} "
                             f"samples, got {tuple(y.shape)}")
        return y

    def rhs(self, y):
        """A^H W y for user-order y: (1, n) complex64 on the device."""
        with tracing.span("indigo.rhs"):
            ys = self._samples(y).reshape(self.nc, -1)[:, self.perm]
            r = self.A.apply((self.wd * ys.reshape(-1))[:, None],
                             adjoint=True)
        return r.reshape(1, -1)

    def solve(self, rhs):
        """CG on the Toeplitz normal op: (image (n,), resids (iters,),
        iteration count (1,) int32), all on the device."""
        pd = self.pd
        precond = None if pd is None else (lambda r: r * pd[None, :])
        with tracing.span("indigo.solve"):
            xs, resids, k = batched_cg(
                lambda v: sense_normal_batched(
                    self.Tf, self.maps, v, coil_chunk=self.coil_chunk,
                    layout=self.layout),
                rhs, lamda=self.lamda, iters=self.iters, tol=self.tol,
                precond=precond, return_iters=True)
        return xs[0], resids[:, 0], k

    def simulate(self, x):
        """k-space (user sample order, coil-major, numpy) from an image. On
        CUDA the array lives in page-locked host memory (``host_copy``),
        which goes back to torch's pinned cache when the caller drops it."""
        if isinstance(x, torch.Tensor):
            x = x.to(self.device, torch.complex64).reshape(-1)
        else:
            x = torch.from_numpy(np.ascontiguousarray(
                np.asarray(x).reshape(-1), dtype=np.complex64)).to(
                    self.device)
        y = self.A.apply(x[:, None])[:, 0]
        y = y.reshape(self.nc, -1)[:, self.inv_perm].reshape(-1)
        return host_array(host_copy(y))

    def forward(self, y, return_resids=False, output="host"):
        """Reconstruct an image from k-space y (user order, coil-major
        (nc*M,) or (nc, M), numpy or tensor).

        output: 'host' returns a numpy complex64 image, on CUDA in
        page-locked host memory (``host_copy``) that goes back to torch's
        pinned cache when the caller drops the array. A caller that holds
        many images holds a block for each (128 MiB at 256^3), and the
        cache keeps those blocks page-locked after they are dropped, for
        the copies that follow. 'device' returns the complex64 tensor on
        the pipeline's device without waiting for it.
        ``last_iters`` is fetched lazily on first read. Each call takes the
        pipeline's next request id, which its spans carry (``tracing``).

        A y tensor that requires grad, with grad mode on, gives an image
        that carries the graph (output 'device'); its backward records
        ``indigo.backward`` > ``indigo.solve_bwd`` and ``indigo.rhs_bwd``
        under the call's request id (``_BackwardSpans``).
        """
        if output not in ("host", "device"):
            raise ValueError(f"unknown output {output!r}")
        self._request += 1
        with tracing.request(self._request):
            if torch.is_grad_enabled() and isinstance(
                    y, torch.Tensor) and y.requires_grad:
                x, resids, k = _BackwardSpans(
                    self._request, self.buffers()).solve(self, y)
            else:
                x, resids, k = self.solve(self.rhs(y))
            self._last_k = k
            x = x.reshape(self.img_shape)
            if output == "host":
                with tracing.span("indigo.egress",
                                  bytes=x.numel() * x.element_size()):
                    x = host_array(host_copy(x))
        if return_resids:
            return x, resids.cpu().numpy()
        return x

    def stream(self, ys, output="host"):
        """Reconstruct a sequence of acquisitions, yielding images in order.

        With output='host', each result's copy to host memory (``host_copy``:
        on a CUDA device a pinned buffer, ``non_blocking``, an event) is
        enqueued right behind its own solve and before the next
        acquisition's solve, so the copy of k overlaps the solve of k+1.
        output='device' yields the device tensors and enqueues no copy:
        overlap is then the caller's choice.
        """
        if output not in ("host", "device"):
            raise ValueError(f"unknown output {output!r}")

        def enqueue(x):
            if output == "device":
                return x
            rid = self._request
            with tracing.request(rid), tracing.span(
                    "indigo.egress", bytes=x.numel() * x.element_size()):
                return host_copy(x), rid

        def fetch(item):
            if output == "device":
                return item
            pending, rid = item
            with tracing.request(rid), tracing.span("indigo.egress"):
                return host_array(pending)

        prev = None
        for y in ys:
            item = enqueue(self(y, output="device"))
            if prev is not None:
                yield fetch(prev)
            prev = item
        if prev is not None:
            yield fetch(prev)

    @property
    def last_iters(self):
        """CG iterations taken by the most recent solve (fetched lazily)."""
        if self._last_k is None:
            return None
        if isinstance(self._last_k, torch.Tensor):
            self._last_k = int(self._last_k[0])
        return self._last_k
