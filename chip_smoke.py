"""Smoke run of indigo_tpu_torch on one NVIDIA GPU: kernels and main paths.

    python3 chip_smoke.py

Phases (each prints one line with its numbers and seconds; any failure
raises and exits non-zero):
  0. device: requires CUDA (there is no CPU fallback); prints the card, its
     power limit (nvidia-smi), torch, CUDA and Triton versions.
  1. build: compiles the CUDA kernels from csrc/ (nvcc, first use) and
     prints each kernel's registers and any stack frame (ptxas -v).
  2. kernel vs plain: sense_normal_cuda against sense_normal_reference on the
     card at 8^3 .. 256^3 and at non-power-of-two axes (rel_err <= 1e-4);
     at 128^3/nc=8 and 256^3/nc=4 the kernel, plain and library times
     (cuFFT through sense_normal_batched(layout="fft"), which the port's
     path never calls), in turns plain, kernel, library, kernel, plain, the
     three passes' ms (z forward, plane, z inverse), each pass's share of
     its bytes floor, the bound, and the calls that took the plane kernel
     (``plane_calls``, which must equal the calls).
  2b. adjoint pad-DFT: pad_idft_cuda (csrc/pad_dft.cu, one pass per
     axis) against pad_idft_reference (the adjoint matrices' einsum) on the
     card at small 2D / 3D shapes and at the main path's 320^3 -> 256^3 with
     8 coils (rel_err <= 1e-5, launches one per axis), and there the
     kernel, plain and library times (torch.fft: ifftn, fftshift, crop and
     sign, which the port's path never calls; plain, kernel, library,
     kernel, plain), the bytes bound (pad_idft_bytes: the grid read and
     the image written once), the passes' own floor (pad_idft_pass_bytes,
     which counts the volumes between the passes too) and one call's
     device time by kernel under torch.profiler.
  3. main path: SenseRecon at the serving-lane size (256^3, 8 coils, 4096 x
     256 kooshball = 1,048,576 samples per coil, oversamp 1.25, width 4,
     10 CG iterations, coil_chunk 4) on the GPU: 3 acquisitions of a noisy
     smooth phantom, the same 3 through ``stream``, then the noise-free
     data once. Checks finite, decreasing residuals, a finite image, the
     kernel launch count (3 passes per K1 call, 2 calls per CG iteration),
     that the plain normal op never ran on the GPU, and that each of the 8
     arrays that left the pipeline (the simulated k-space, 3 calls, 3
     streamed images, the noise-free call) came through pinned memory
     (``host_copy``'s counts, printed as pinned_copies);
     a small problem is also reconstructed on the GPU and on the CPU and the
     two compared, at 32^3 (periodic tiling, GridDFT) and at 16^3 (grid
     20^3, which the tiling does not cover: KBInterp * CenteredDFT).
  4. spmm kernels: K3 (jag_spmm_cuda) and K4 (ell_spmm_cuda), one
     row-gather kernel on each matrix's row form, against their plain
     versions on the card (rel_err <= 1e-5) and against a second launch
     (bitwise equal): small shapes at bm 8, 16 and 128, then the radial
     path's own matrices (G and G^H at 256^2 as jag, G as ELL at 256^2, G^H
     as ELL at 128^2; 16 real columns), with each matrix's row-nonzero mean
     and max, kernel, plain and library ms (cuSPARSE through
     torch.sparse.mm on the same matrix as CSR; plain, kernel, library,
     kernel, plain; kernel and library timed on the card with the host
     ahead of it, since a kernel of ~30 us is shorter than its wrapper's
     host time), the kernel's evented wall per call (host included), the
     library's time over the kernel's, the bound from the nonzeros, and,
     where rows are split across a block, the kernel's time at other split
     thresholds and with none.
  5. radial 2D path: the reference's 2D radial CG-SENSE recipe at 256^2,
     8 coils, 384 spokes x 512 readout points (196,608 samples per coil),
     oversamp 1.5 (grid 384^2), width 4: sense_nufft_op(interp="sparse") on
     the GPU, y = A x + 1 % noise, A^H y, then two solves of
     cg(A^H A, lamda=0.1, tol=0, maxiter=30, history=True). Checks finite,
     decreasing residuals, a finite image, the K3 launch count and that no
     SpMM took the plain path on the GPU; the same recipe at 64^2/4 coils on
     the GPU and on the CPU (<= 1e-4); and a 128^2 solve whose gridding leaf
     is blocked-ELL (K4) against the jag (K3) solve (<= 1e-4).
  6a. K2 kernel vs plain: toeplitz_apply_cuda against
     toeplitz_apply_reference on the card at 8^3 .. 256^3 and at
     non-power-of-two axes (rel_err <= 1e-4), and at 128^3 and 256^3 with
     B = 8 the kernel, plain and library times (cuFFT through
     ops/toeplitz_fft; plain, kernel, library, kernel, plain), the three
     passes' ms, each pass's share of its bytes floor, the bound and
     ``plane_calls``, as in phase 2.
  6b. Toeplitz operator-tree path: the reference's 3D CG-SENSE recipe with
     Pipe-Menon DCF at the serving-lane size (256^3, 8 coils, the same
     kooshball, oversamp 1.25, width 4): pipe_menon_dcf (20 iterations, on
     the GPU), toeplitz_kernel, sense_nufft_op, sense_normal_toeplitz
     (coils.H * KronI(8, ToeplitzNormal) * coils), rhs = A^H W y, then two
     solves of cg(N, rhs, lamda, tol=0, maxiter=10, history=True) and one
     on the noise-free data. Checks
     finite, decreasing residuals, a finite image, exactly 33 K2 launches
     per solve (11 applies x 3 passes), no plain Toeplitz apply and no K1
     launch on the GPU.
  6c. cross-checks: one tree apply (K2) against sense_normal_batched
     (layout "kernel", K1) on the same spectrum; the 256^3 tree solve
     against sense_batch_recon (K1, coil_chunk 4) at the same lamda and
     iterations; the recipe at 32^3/4 coils on the GPU and on the CPU (and
     the device DCF on the GPU against the host DCF); SenseRecon(dcf=
     "pipe_menon") at 32^3 on the GPU and on the CPU. All <= 1e-4.
  7. Cartesian CG-SENSE with the tree optimizer (the reference's config-1
     recipe as a 3D scan): 256^3, 8 coils, the serving lane's maps and
     phantom; mask fully sampled along axis 0, every 2nd line in axes 1 and
     2 plus a 32 x 32 fully sampled centre (26 % of k-space).
     A = cartesian_sense_op(mask, maps) (on the GPU by its default),
     y = A x + 1 % noise,
     N = (A.H * A).optimize() (host spGEMM: Mask.H * Mask fuses into one
     Diag; seconds and peak host memory printed), rhs = A.H * y, lamda =
     1e-3 x max_eigen(N) (and max_eigen(N, dtype=np.complex64), the
     reference's call form, equal to it), two solves of cg(N, rhs, lamda,
     tol=0, maxiter=10, history=True). Checks: the nonzero cap of the
     fusion was not hit and no Mask leaf is left in N; one apply of N equals
     one of A.H * A (<= 1e-5); finite, decreasing residuals; a finite image.
     Small check, GPU and CPU: the recipe exactly as
     examples/cartesian_sense_2d.py writes it (SpMatrix(P) * UnscaledFFT *
     Diag, optimize, cg at lamda 1e-6) at 128^2. Its system is singular,
     so rounding decides the image's null-space part: each device is held
     to the example's own bar (data consistency < 1e-3) and, for the part
     of its image in range(A^H) (projected in float64), to the float64
     minimum-norm solution and to the other device (<= 1e-4, or twice the
     f32 storage rounding of the whole image where that is larger); the
     images of the same optimized operator at a well-posed lamda are
     compared whole (<= 1e-4).
  8. l1-wavelet FISTA (the reference's config-4 recipe,
     examples/cs_wavelet_fista.py, in 3D): the same 256^3 / 8 coils; a
     variable-density mask in axes 1-2 (the example's density law per
     axis, their product, 24 x 24 centre, ~6x undersampling), fully
     sampled along axis 0; W = DWT(256^3, db4, 3 levels); L = 1.05 x
     max_eigen(A.H * A, 30 iterations); two runs of apgd(gradf, proxg,
     1/L, maxiter=30, history=True, objective=...) in the wavelet domain.
     Checks: finite; the objective falls over the run and over its second
     half, and no single iteration raises it by more than 1e-3; the CS
     image is closer to the phantom than the zero-filled one. Prints s per
     iteration beside its bytes floor (the operators' cost() bytes over
     the card's memory rate) and the ms of W, W.H, A, A.H and the prox one
     by one. Small check, GPU vs CPU (<= 1e-4): the example's defaults
     (128^2, 4 coils, 100 iterations).
  Neither of these two paths launches a hand-written kernel (the reference
  runs them without one): their [profile] lines say where their time goes.
  9. sharded (the multi-device paths of ``parallel/``, on the ONE card): 4
     ranks started by ``parallel.launch``, each with ``cuda:0``, talking
     over gloo; the kernels are the library phase 1 built. Every tensor of
     the computation lives on the card; only the collectives' payloads
     cross the host (pinned staging buffers, ``parallel.collectives``).
     This measures correctness and what that transport costs, not scaling:
     four ranks time-slice one card, and no time here says anything of four
     cards. At 256^3 / 8 coils, the serving lane's kooshball, maps and
     phantom, 10 CG iterations:
     (d) fftn_sharded (x=4) and fftn_sharded2 (x=2, y=2) on a 256^3 volume,
         forward and inverse, against torch.fft on the card (<= 1e-5);
     (a) sense_batch_recon(mesh=(slice=2, coil=2)) on 2 right-hand sides,
         1 slice x 4 coils per rank, against sense_batch_recon(mesh=None)
         (<= 1e-4); K1 launches on every rank (3 per normal-op call), no
         plain normal op on the card, finite decreasing residuals;
     (b) sense_vol_recon(mesh=(vol=4)) and sense_vol_recon2 (vz=2, vy=2) on
         one of them, against the same single-device solve (<= 1e-4);
     (c) SenseReconSharded(vol=4, dcf="radial") on one noisy acquisition
         against SenseRecon on the same grid (320^3: the mesh pads
         nothing) (<= 1e-4).
     Each of (a)-(c) prints first and warm seconds per solve, seconds per
     iteration, the bytes each rank sent per iteration, the share of the
     solve inside collectives, the transport and the peak memory per rank.
     (e) one rank over NCCL at 64^3: (a) and (b) once more; with one rank
         every mesh axis has size 1 and the entry points skip their
         collectives, so the check is that the path runs and equals the
         single-device answer, and the three transport functions
         (all_to_all_single, all_reduce, all_gather) are called directly on
         the NCCL group and must return their input.
  10. the rest of the package, one line per part:
     (a) native: the C++ gridding code (built with g++ on first use; it
         must load, nothing falls back) against the numpy build on the
         256^2 radial trajectory (grid 384^2) and the serving kooshball
         (1,048,576 samples, grid 320^3): equal nonzeros, max |diff| <=
         1e-5; both builds' seconds and the OpenMP threads;
     (b) profiling: measure_hbm_bandwidth() beside the 3.35e12 peak, the
         row-gather cost behind GATHER_SEC_PER_ROW, roofline_report of one
         apply of phase 7's A, and toeplitz_cg_iter_bytes(layout="kernel")
         / _macs at 256^3 / 8 coils beside phase 3's seconds per iteration;
     (c) backends: get_backend("cuda") and ("numpy") on the card; csrmm on
         the 256^2 radial gridding matrix bitwise equal to the SpMatrix
         applied directly (one K3 launch), and from its scipy CSR
         (<= 1e-5); fftn/ifftn at 256^3 against torch.fft and cg through
         the facade on the 64^2 radial recipe against solvers.cg (<= 1e-5);
     (d) checkpoint: a 256^3 complex64 volume round trip (bitwise, save and
         load seconds), and the 256^2 radial cg at a well-conditioned lamda
         stopped at 15 iterations, saved, loaded and resumed, against 30
         straight (<= 1e-4);
     (e) examples: the five example scripts at their default sizes on the
         card, their own asserts inside; K1 must launch in multicoil_3d and
         serving_pipeline, K3 in radial_sense_2d. Their launches are added
         to the kernels line.
  11. the reference's boundary: the 3D Toeplitz recipe written as a user of
     the reference writes it, with numpy's default float64 / complex128
     inputs and no device= anywhere, at 256^3 / 8 coils on the serving
     kooshball (seed 0). Checks: pipe_menon_dcf and toeplitz_kernel took
     their device path (their gathers ran on the card, the host gridding
     matrix was never built; seconds printed); sense_normal_toeplitz(Tf,
     maps_c128) lives on the card with complex64 / float32 buffers;
     cg(N, b_c128, maxiter=10) launches K2 (33 launches per solve) and
     returns complex64 on the card, equal (<= 1e-4) to the same solve built
     from complex64 tensors with device="cuda" (both timed, and the numpy
     b's narrowing and copy to the card apart); on the 2D radial lane a bare
     SpMatrix(G) of the float64 scipy gridding matrix runs K3,
     set_spmm_impl("jnp") launches no K3 and equals the kernel (<= 1e-5),
     "auto" restores it; sense_batch_recon(Tf, maps_c128, rhs_c128) runs K1
     and equals the tree solve (<= 1e-4). Then the reference's call forms:
     csr_to_jag / csr_to_bell(G_f64, dtype=np.float64) hold float32 and run
     one K3 / K4 per apply, no plain SpMM, bitwise the default conversion's
     result (ms per apply printed); the serving plan from every (adjoint,
     forward, reorder) keyword of plan_tile_interp gives one plan without
     reorder, and with it the group-major order under forward="grouped"
     only (S, GB and build seconds printed); centered_fft_op(256^3,
     dtype=np.complex128) returns complex64, bitwise the complex64 op's.
     Its launches are added to the kernels line.
  12. gradients (each part on the objects of the lane it differentiates,
     right after that lane's phase; the K1/K2 part last), one line each with
     the card's name and power limit:
     (c) after phase 3, the main path differentiated: L = |x - x_true|^2 of
         SenseRecon(y, output="device") at the serving size with y a k-space
         tensor that requires grad, then backward. Checks: the gradient is
         finite; 20 K1 calls forward and 20 backward; no plain call; at the
         noisy y and at the noise-free y0, a central difference along one
         seeded direction at each of FD_STEPS against Re<grad, d> (all
         printed), the smallest within FD_TOL. Prints the warm forward s,
         the forward with its graph and the backward, first and warm, the
         peak GB, and a [profile] line of one forward with its graph and its
         backward;
     (a) after phase 5, K3 on G and G^H at 256^2 (SpMatrix) and K4 at 128^2
         (format "bell"), each direction; at the end K1 at 256^3 / nc 4 and
         K2 at 256^3 / B 8: autograd's gradient bitwise the explicit adjoint
         call on the same cotangent, one kernel call per backward, no plain
         call, within 1e-4 (K1/K2) / 1e-5 (K3/K4) of the plain version's
         autograd on the card (K1/K2 at 256^3 where the card holds the
         plain version's saved stages, else at 128^3; the line says which);
         forward and backward ms;
     (b) after phases 5 and 6c, the silent case: the gradient of
         |(N + lam I) x - b|^2 against 2 (N + lam I)((N + lam I) x - b)
         from explicit applies (<= 1e-5), on the radial N = A.H * A (K3)
         and on the 3D tree (K2). ``f9_reading()`` prints the same two
         readings held to no bar, for a tree whose kernels cut the graph;
     (d) after (b) on the radial lane, what the Function would cost the
         host-bound solve: warm 256^2 solves as shipped (no grad, so the
         bare K3 launch) and with every launch forced through _SpmmFn,
         alternating; medians and the difference per solve and per launch
         (not counted below).
     Their forward and backward launches are added to the kernels line.
     phase_gradients() runs the same parts alone, building each lane.
After the counted runs, one warm solve of each path runs under
torch.profiler ([profile] lines: device time by kernel, busy share; for the
radial solve also K3's share and the launches per CG iteration).
The line before the last holds the per-kernel JSON record (launches, error,
kernel / plain / library ms, bound); the last line is the result object.
"""
import json
import os
import re
import subprocess
import sys
import time
from functools import partial

import numpy as np

# the bounds' single source: H100 SXM peaks (3.35 TB/s HBM3, 67 TFLOP/s f32)
from indigo_tpu_torch.profiling import (
    HBM_BYTES_PER_SEC as HBM_BYTES_PER_S, pass_bytes, spmm_bound,
    toeplitz_bound)

SEED = 0
N, NC, NSPOKES, NREAD = 256, 8, 4096, 256
OVERSAMP, WIDTH, ITERS, COIL_CHUNK = 1.25, 4, 10, 4
KERNEL_TOL = 1e-4
PATH_TOL = 1e-4


def log(phase, t0, **fields):
    items = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {items} seconds={time.time() - t0:.3f}", flush=True)


def kooshball_traj(nspokes, nread, seed=0):
    """3D kooshball radial trajectory (M, 3) — the serving-lane geometry."""
    rng = np.random.default_rng(seed)
    u = rng.random(nspokes)
    v = rng.random(nspokes)
    th = np.arccos(2 * u - 1)
    ph = 2 * np.pi * v
    dirs = np.stack([np.sin(th) * np.cos(ph),
                     np.sin(th) * np.sin(ph),
                     np.cos(th)], axis=1)
    r = (np.arange(nread) - nread // 2) / nread
    return (dirs[:, None, :] * r[None, :, None]).reshape(-1, 3)


def coil_maps(n, nc, seed=0):
    """Smooth coil maps with linear phase (the serving lane's maps)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    maps = []
    for _ in range(nc):
        a, b, cph = rng.random(3)
        amp = 0.4 + np.exp(-(((xx - a) ** 2 + (yy - b) ** 2
                              + (zz - cph) ** 2) * 3))
        maps.append(amp * np.exp(1j * 2 * np.pi * (a * xx + b * yy)))
    return np.asarray(maps, dtype=np.complex64)


def phantom(n):
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / n
    r2 = (zz - .5) ** 2 + (yy - .5) ** 2 + (xx - .45) ** 2
    return (np.exp(-r2 * 9) + 0.5 * np.exp(-((xx - .6) ** 2 + (yy - .4) ** 2
                                             + (zz - .5) ** 2) * 60)
            ).astype(np.complex64)


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_device():
    t0 = time.time()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs a GPU")
    print(card_line(), flush=True)
    try:  # the port uses no Triton; the version is recorded for later work
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    log("device", t0, name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, triton=triton_version)


def kernel_registers(ptxas_log):
    """[(kernel, registers, stack frame bytes)] from nvcc's -Xptxas -v
    output, each entry function named as in the source
    (kern_inv<16,16,true>, row_spmm<4,true>)."""
    regs, name, stack = [], None, 0
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, stack = m.group(1), 0
        m = re.search(r"(\d+) bytes stack frame", ln)
        if m and name:
            stack = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            # the digit is the mangled length prefix, which the namespace
            # tag of the file (..._block_spmm_cu_...) does not have
            k = re.search(r"(?<=\d)(kern_fwd|kern_inv|kern_x|row_spmm|"
                          r"kern_pad_idft)"
                          r"(I(?:L[ib]\d+E)+E)?", name)
            args = re.findall(r"L([ib])(\d+)E", k.group(2) or "") if k else []
            vals = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in args]
            label = (k.group(1) + (f"<{','.join(vals)}>" if vals else "")
                     if k else name)
            regs.append((label, int(m.group(1)), stack))
            name = None
    return regs


def phase_build():
    t0 = time.time()
    from indigo_tpu_torch.ops._build import load_library, build_dir
    load_library()
    with open(os.path.join(build_dir(), "build.log")) as f:
        regs = kernel_registers(f.read())
    log("build", t0, registers=",".join(f"{k}:{r}" for k, r, _ in regs),
        stack_bytes=",".join(f"{k}:{b}" for k, _, b in regs if b) or "none")


def timed(fn, reps):
    """Mean ms per call over reps calls, CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Mean ms per call of fn on the card, with the host ahead of it: a
    sleep kernel holds the stream while the reps calls are enqueued, so the
    events time them back to back on the card and not the host's enqueue
    (a kernel of ~30 us is shorter than its wrapper's host time, which
    ``timed`` would measure). Checks that the host did get ahead."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int(4e9 * (time.perf_counter() - t0)) + 1_000_000
    for _ in range(4):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # the card was still asleep
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("queued_ms: the host never got ahead of the card")


def profile_solve(label, fn, kernel=None, iters=None):
    """One call of fn under torch.profiler: the device time by kernel (the
    CUDA activities CUPTI records, ctypes launches included), their union
    against the host wall (busy share). Prints one [profile] line; with
    ``kernel`` (a substring of a kernel's name) also that kernel's share of
    the device time, and with ``iters`` the launches of it and of all
    device activities per iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans, by_name, n_kernel = [], {}, 0
    for e in prof.events():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        key = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name)
        key = key.split("(")[0].replace(" ", "")
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
        n_kernel += bool(kernel) and kernel in key
    if not spans:
        print(f"[profile] path={label} wall_s={wall:.4f} device=not measured "
              "(no CUDA activity in the trace)", flush=True)
        return
    busy, end = 0.0, -1e30
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy /= 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    dev = sum(by_name.values())
    extra = ""
    if kernel:
        k_s = sum(t for k, t in by_name.items() if kernel in k)
        extra += f"{kernel}_s={k_s:.4f} {kernel}_share={k_s / dev:.4f} "
    if kernel and iters:
        extra += (f"{kernel}_launches_per_iter={n_kernel / iters:.2f} "
                  f"device_ops_per_iter={len(spans) / iters:.2f} ")
    print(f"[profile] path={label} wall_s={wall:.4f} device_s={dev:.4f} "
          f"busy_s={busy:.4f} busy_share={busy / wall:.4f} {extra}top="
          + ";".join(f"{k}:{t:.4f}s:{t / dev:.3f}" for k, t in top[:8]),
          flush=True)


def toeplitz_timing(kernel, plain, library, shape, S, nc, wrapper):
    """Kernel, plain and library ms in turns (plain, kernel, library,
    kernel, plain), then the three passes' ms (z forward, plane, z inverse)
    from one evented call, the bound (toeplitz_bound), each pass's share of
    its own bytes floor (pass_bytes over the card's memory rate), and the
    calls of ``wrapper`` (K1's or K2's) that took the plane kernel against
    all its calls here, which must be equal."""
    import torch
    reps = TIMING_REPS[shape[0]]
    from indigo_tpu_torch.ops.dft_cuda import LAUNCHES_PER_CALL
    planes0, launches0 = wrapper.plane_calls, wrapper.launches
    p1 = timed(plain, reps["plain"])
    k1 = timed(kernel, reps["kernel"])
    lib = timed(library, reps["library"])
    k2 = timed(kernel, reps["kernel"])
    p2 = timed(plain, reps["plain"])
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(LAUNCHES_PER_CALL + 1)]
    kernel(events=ev)
    torch.cuda.synchronize()
    per = [ev[i].elapsed_time(ev[i + 1]) for i in range(LAUNCHES_PER_CALL)]
    calls = (wrapper.launches - launches0) // LAUNCHES_PER_CALL
    planes = wrapper.plane_calls - planes0
    if planes != calls:
        raise AssertionError(f"{wrapper.__name__} at {shape}: {planes} "
                             f"plane-kernel calls of {calls}")
    b_ms, b_by = toeplitz_bound(shape, S, nc)
    floors = [b / HBM_BYTES_PER_S * 1e3 for b in pass_bytes(shape, S, nc)]
    timing = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib,
                  bound_ms=b_ms, bound_by=b_by)
    fields = dict(kernel_ms=f"{k1:.3f},{k2:.3f}",
                  plain_ms=f"{p1:.3f},{p2:.3f}", library_ms=f"{lib:.3f}",
                  fz_plane_iz_ms=",".join(f"{x:.3f}" for x in per),
                  pass_share_of_bytes_floor=",".join(
                      f"{f / t:.3f}" for f, t in zip(floors, per)),
                  bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                  share_of_bound=f"{b_ms / timing['ms']:.4f}",
                  plane_calls=planes, calls=calls)
    return timing, fields


TIMING_REPS = {128: dict(plain=5, kernel=20, library=10),
               256: dict(plain=3, kernel=10, library=5)}
# every phase-2/6a shape; (24, 136, 40) and (8, 256, 16) reach the direct-sum
# and the 16 x 16 factor plans on axes other than the cube's
TOEPLITZ_SHAPES = [(8, 8, 8), (8, 16, 24), (16, 136, 8), (24, 136, 40),
                   (8, 256, 16), (128, 128, 128), (256, 256, 256)]


def phase_kernels():
    import torch
    from indigo_tpu_torch.ops.dft_cuda import (
        kernel_spectrum, sense_normal_cuda, sense_normal_reference)
    from indigo_tpu_torch.parallel.recon import sense_normal_batched
    from indigo_tpu_torch.utils import rand64c, rel_err

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    counts = {(8, 8, 8): (1, 2), (8, 16, 24): (2, 3), (16, 136, 8): (1, 2),
              (24, 136, 40): (2, 3), (8, 256, 16): (1, 2),
              (128, 128, 128): (1, 8), (256, 256, 256): (1, 4)}
    worst = 0.0
    timing = {}
    for shape in TOEPLITZ_SHAPES:
        S, nc = counts[shape]
        t0 = time.time()
        Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(
            np.float32)
        T = torch.from_numpy(kernel_spectrum(Tf)).to(dev)
        m = torch.from_numpy(rand64c(nc, *shape, rng=rng)).to(dev)
        v = torch.from_numpy(rand64c(S, *shape, rng=rng)).to(dev)
        out = sense_normal_cuda(T, m, v)
        ref = sense_normal_reference(T, m, v)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        abs_err = float((out - ref).abs().max())
        del out, ref
        if not err <= KERNEL_TOL:
            raise AssertionError(f"kernel vs plain at {shape} S={S} "
                                 f"nc={nc}: rel_err {err:.3e}")
        worst = max(worst, abs_err)
        fields = dict(shape="x".join(map(str, shape)), S=S, nc=nc,
                      rel_err=f"{err:.3e}", max_abs_err=f"{abs_err:.3e}")
        if shape[0] >= 128:
            # the library route reads the raw-order spectrum itself
            T_raw = torch.from_numpy(Tf).to(dev)
            xs = v.reshape(S, -1)

            def library():
                return sense_normal_batched(T_raw, m, xs, layout="fft")
            lib_err = rel_err(library().reshape(v.shape),
                              sense_normal_cuda(T, m, v))
            if not lib_err <= KERNEL_TOL:
                raise AssertionError(f"library route vs kernel at {shape}: "
                                     f"rel_err {lib_err:.3e}")
            timing[shape[0]], tf = toeplitz_timing(
                lambda events=None: sense_normal_cuda(T, m, v, events=events),
                lambda: sense_normal_reference(T, m, v), library, shape, S,
                nc, sense_normal_cuda)
            fields.update(tf, rel_err_library=f"{lib_err:.3e}")
            del T_raw, xs
        del T, m, v
        torch.cuda.empty_cache()
        log("kernel", t0, **fields)
    return worst, timing


# (img, grid, K) of phase 2b; the last is the main path's rhs
PAD_DFT_SHAPES = [((13, 31), (24, 40), 3), ((29, 51), (40, 64), 8),
                  ((12, 16, 256), (16, 24, 320), 8),
                  ((13, 301), (16, 512), 2),
                  ((25, 7, 200), (32, 16, 256), 1),
                  ((256, 256, 256), (320, 320, 320), 8)]


def pad_idft_library(x, img):
    """The adjoint pad-DFT by torch.fft (cuFFT), the yardstick only: per
    axis out[j] = (-1)^(j+o+g/2) ifft(x)[(j + o + g/2) mod g], unnormalised."""
    import torch
    axes = tuple(range(1, x.dim()))
    y = torch.fft.fftshift(torch.fft.ifftn(x, dim=axes, norm="forward"),
                           dim=axes)
    sign = 1.0
    for d, (n, g) in enumerate(zip(img, x.shape[1:])):
        o = (g - n) // 2
        y = y.narrow(d + 1, o, n)
        s = (-1.0) ** (np.arange(n) + o + g // 2)
        sign = np.multiply.outer(sign, s)
    return y * torch.from_numpy(sign.astype(np.float32)).to(x.device)


def phase_pad_dft():
    """Phase 2b: returns (worst max |err|, the main-path timing, the
    phase's kernel launches)."""
    import torch
    from indigo_tpu_torch.ops.pad_dft_cuda import (
        pad_idft_bytes, pad_idft_cuda, pad_idft_pass_bytes,
        pad_idft_reference)
    from indigo_tpu_torch.utils import rel_err

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst, timing, at_start = 0.0, None, pad_idft_cuda.launches
    for img, grid, K in PAD_DFT_SHAPES:
        t0 = time.time()
        x = torch.randn((K,) + grid, dtype=torch.complex64, device=dev,
                        generator=gen)
        before = pad_idft_cuda.launches
        out = pad_idft_cuda(x, img)
        ref = pad_idft_reference(x, img)
        torch.cuda.synchronize()
        if pad_idft_cuda.launches - before != len(img):
            raise AssertionError(f"pad_idft_cuda at {grid}: "
                                 f"{pad_idft_cuda.launches - before} "
                                 "launches, not one per axis")
        err = rel_err(out, ref)
        abs_err = float((out - ref).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"pad-DFT kernel vs plain at {img} <- "
                                 f"{grid} K={K}: rel_err {err:.3e}")
        worst = max(worst, abs_err)
        fields = dict(img="x".join(map(str, img)),
                      grid="x".join(map(str, grid)), K=K,
                      rel_err=f"{err:.3e}", max_abs_err=f"{abs_err:.3e}")
        del out, ref
        if grid[0] == 320:
            lib_err = rel_err(pad_idft_library(x, img), pad_idft_cuda(x, img))
            if not lib_err <= 1e-5:
                raise AssertionError(f"library route vs kernel: rel_err "
                                     f"{lib_err:.3e}")
            p1 = timed(lambda: pad_idft_reference(x, img), 3)
            k1 = timed(lambda: pad_idft_cuda(x, img), 20)
            lib = timed(lambda: pad_idft_library(x, img), 10)
            k2 = timed(lambda: pad_idft_cuda(x, img), 20)
            p2 = timed(lambda: pad_idft_reference(x, img), 3)
            b_ms = pad_idft_bytes(img, grid, K) / HBM_BYTES_PER_S * 1e3
            pass_ms = [b / HBM_BYTES_PER_S * 1e3
                       for b in pad_idft_pass_bytes(img, grid, K)]
            timing = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                          library_ms=lib, bound_ms=b_ms, bound_by="bytes")
            fields.update(kernel_ms=f"{k1:.3f},{k2:.3f}",
                          plain_ms=f"{p1:.3f},{p2:.3f}",
                          library_ms=f"{lib:.3f}", bound_ms=f"{b_ms:.4f}",
                          bound_by="bytes",
                          share_of_bound=f"{b_ms / timing['ms']:.4f}",
                          pass_floor_ms=",".join(f"{t:.4f}" for t in pass_ms),
                          share_of_pass_floor=(
                              f"{sum(pass_ms) / timing['ms']:.4f}"),
                          rel_err_library=f"{lib_err:.3e}",
                          launches=pad_idft_cuda.launches - at_start)
            profile_solve("pad_idft_320^3_K8", lambda: pad_idft_cuda(x, img),
                          kernel="kern_pad_idft")
        log("pad_dft", t0, **fields)
        del x
        torch.cuda.empty_cache()
    return worst, timing, pad_idft_cuda.launches - at_start


def small_path_check():
    """A small recon on the GPU (kernel path) vs on the CPU (plain path)."""
    import torch
    from indigo_tpu_torch.models import SenseRecon
    from indigo_tpu_torch.utils import rand64c, rel_err

    t0 = time.time()
    traj = kooshball_traj(512, 32, seed=SEED)
    maps = coil_maps(32, 4, seed=SEED)
    kw = dict(oversamp=OVERSAMP, width=WIDTH, iters=ITERS, coil_chunk=2)
    gpu = SenseRecon(traj, maps, device="cuda", **kw)
    cpu = SenseRecon(traj, maps, device="cpu", **kw)
    if gpu.layout != "kernel":
        raise AssertionError(f"GPU layout {gpu.layout}")
    y = gpu.simulate(phantom(32))
    y = y + 0.01 * np.abs(y).max() * rand64c(y.shape[0], rng=SEED)
    xg = gpu(y)
    xc = cpu(y)
    err = rel_err(xg, xc)
    if not err <= PATH_TOL:
        raise AssertionError(f"small recon GPU vs CPU rel_err {err:.3e}")
    del gpu, cpu
    torch.cuda.empty_cache()
    log("path_small", t0, shape="32^3", nc=4, rel_err_gpu_vs_cpu=f"{err:.3e}")

    # grid 20^3 is not a multiple of the (4, 4, 8) tile: the halo plan
    t0 = time.time()
    from indigo_tpu_torch.operators import KBInterp
    traj = kooshball_traj(96, 16, seed=SEED)
    maps = coil_maps(16, 2, seed=SEED)
    kw = dict(oversamp=OVERSAMP, width=WIDTH, iters=ITERS)
    gpu = SenseRecon(traj, maps, device="cuda", **kw)
    cpu = SenseRecon(traj, maps, device="cpu", **kw)
    if not any(isinstance(m, KBInterp) for m in gpu.A.modules()):
        raise AssertionError("16^3 recon did not take the halo gridding")
    y = gpu.simulate(phantom(16))
    y = y + 0.01 * np.abs(y).max() * rand64c(y.shape[0], rng=SEED)
    err = rel_err(gpu(y), cpu(y))
    if not err <= PATH_TOL:
        raise AssertionError(f"16^3 halo recon GPU vs CPU rel_err {err:.3e}")
    del gpu, cpu
    torch.cuda.empty_cache()
    log("path_small_halo", t0, shape="16^3", grid="20^3", nc=2,
        rel_err_gpu_vs_cpu=f"{err:.3e}")


def serving_data(recon, x_true):
    """The serving lane's k-space: the noise-free y0 and three noisy
    acquisitions, complex white noise at 1 % of the k-space RMS (40 dB
    SNR) from seed SEED + 1."""
    y0 = recon.simulate(x_true)
    rng = np.random.default_rng(SEED + 1)
    sigma = 0.01 * float(np.sqrt(np.mean(np.abs(y0) ** 2) / 2))
    return y0, [y0 + sigma * (rng.standard_normal(y0.shape, dtype=np.float32)
                              + 1j * rng.standard_normal(y0.shape,
                                                         dtype=np.float32))
                for _ in range(3)]


def serving_recon(traj, maps):
    """The serving lane's SenseRecon on the card."""
    from indigo_tpu_torch.models import SenseRecon
    return SenseRecon(traj, maps, oversamp=OVERSAMP, width=WIDTH,
                      iters=ITERS, coil_chunk=COIL_CHUNK, device="cuda")


def phase_main_path():
    import torch
    from indigo_tpu_torch.models.recon import host_copy
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.dft_cuda import (
        LAUNCHES_PER_CALL, sense_normal_cuda, sense_normal_reference)
    from indigo_tpu_torch.ops.pad_dft_cuda import pad_idft_cuda
    from indigo_tpu_torch.utils import rel_err

    small_path_check()
    t0 = time.time()
    traj = kooshball_traj(NSPOKES, NREAD, seed=SEED)
    maps = coil_maps(N, NC, seed=SEED)
    M = len(traj)
    log("data", t0, samples_per_coil=M, coils=NC, shape=f"{N}^3")

    torch.cuda.reset_peak_memory_stats()
    sense_normal_cuda.launches = 0
    pad_idft_cuda.launches = 0
    sense_normal_reference.cuda_calls = 0
    spmm.plain_cuda_calls = 0
    t0 = time.time()
    recon = serving_recon(traj, maps)
    torch.cuda.synchronize()
    if recon.layout != "kernel":
        raise AssertionError(f"main path layout {recon.layout}")
    if sense_normal_cuda.launches != 0:
        raise AssertionError("the pipeline build launched the normal op")
    log("init", t0, layout=recon.layout, lamda=f"{recon.lamda:.4g}")

    t0 = time.time()
    copies = (host_copy.pinned_copies, host_copy.pageable_copies)
    x_true = phantom(N)
    y0, ys = serving_data(recon, x_true)
    log("simulate", t0, samples=y0.shape[0])

    per_solve = LAUNCHES_PER_CALL * ITERS * (NC // COIL_CHUNK)
    # the rhs's adjoint pad-DFT: one kernel launch per image axis
    per_rhs = 3
    pad_at_init = pad_idft_cuda.launches
    times = []
    for i, y in enumerate(ys):
        t0 = time.time()
        before = sense_normal_cuda.launches
        pad_before = pad_idft_cuda.launches
        x, res = recon(y, return_resids=True)
        times.append(time.time() - t0)
        grew = sense_normal_cuda.launches - before
        if pad_idft_cuda.launches - pad_before != per_rhs:
            raise AssertionError(
                f"acquisition {i}: {pad_idft_cuda.launches - pad_before} "
                f"pad-DFT launches in the rhs, expected {per_rhs}")
        if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
            raise AssertionError(f"acquisition {i}: residuals {res}")
        if x.shape != (N, N, N) or not np.all(np.isfinite(x)):
            raise AssertionError(f"acquisition {i}: image not finite")
        if grew != per_solve:
            raise AssertionError(f"acquisition {i}: {grew} kernel launches, "
                                 f"expected {per_solve}")
        log("acquisition", t0, index=i, kind="first" if i == 0 else "warm",
            launches=grew, resid_first=f"{res[0]:.4e}",
            resid_last=f"{res[-1]:.4e}",
            rel_err_vs_phantom=f"{rel_err(x, x_true):.4f}")

    t0 = time.time()
    before = sense_normal_cuda.launches
    pad_before = pad_idft_cuda.launches
    out = list(recon.stream(ys))
    t_stream = (time.time() - t0) / len(out)
    if sense_normal_cuda.launches - before != len(ys) * per_solve:
        raise AssertionError("stream launch count")
    if pad_idft_cuda.launches - pad_before != len(ys) * per_rhs:
        raise AssertionError(f"{pad_idft_cuda.launches - pad_before} "
                             "pad-DFT launches in the stream, expected "
                             f"{len(ys) * per_rhs}")
    if not all(o.shape == (N, N, N) and np.all(np.isfinite(o))
               for o in out):
        raise AssertionError("stream output not finite")
    log("stream", t0, acquisitions=len(out),
        seconds_per_acq=f"{t_stream:.3f}")
    t0 = time.time()
    x_clean = recon(y0)
    log("noise_free", t0, rel_err_vs_phantom=f"{rel_err(x_clean, x_true):.4f}")
    if sense_normal_cuda.launches != (len(ys) * 2 + 1) * per_solve:
        raise AssertionError(f"{sense_normal_cuda.launches} kernel launches "
                             "in the main path")
    pad_launches = pad_idft_cuda.launches - pad_at_init
    if pad_launches != (len(ys) * 2 + 1) * per_rhs:
        raise AssertionError(f"{pad_launches} pad-DFT launches in the "
                             "main path's requests")
    if sense_normal_reference.cuda_calls != 0 or spmm.plain_cuda_calls:
        raise AssertionError("the plain normal op or a plain SpMM ran on "
                             "the GPU")
    # simulate, 3 calls, 3 streamed, the noise-free call: each array pinned
    pinned = host_copy.pinned_copies - copies[0]
    if (pinned, host_copy.pageable_copies - copies[1]) != (8, 0):
        raise AssertionError(f"{pinned} pinned and "
                             f"{host_copy.pageable_copies - copies[1]} "
                             "pageable copies to the host, expected 8 and 0")
    print(f"[summary] first_s={times[0]:.3f} warm_s="
          f"{','.join(f'{t:.3f}' for t in times[1:])} stream_s_per_acq="
          f"{t_stream:.3f} launches={sense_normal_cuda.launches} "
          f"pad_idft_launches={pad_launches} pinned_copies={pinned} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
    launches = sense_normal_cuda.launches
    profile_solve("serving", lambda: recon(ys[1]))
    return launches, pad_launches, min(times[1:]) / ITERS, dict(
        recon=recon, y0=y0, y=ys[1], x_true=x_true)


RADIAL_N, RADIAL_NC, RADIAL_ITERS, RADIAL_LAMDA = 256, 8, 30, 0.1
SPMM_TOL = 1e-5
RECIPE_F32_TOL = 2e-3  # see radial_small_check


def radial_traj(nspokes, nread):
    """2D radial trajectory (M, 2): nspokes spokes of nread points."""
    ang = np.pi * np.arange(nspokes) / nspokes
    r = (np.arange(nread) - nread // 2) / nread
    return np.stack([np.outer(np.cos(ang), r).ravel(),
                     np.outer(np.sin(ang), r).ravel()], axis=1)


def smooth_maps_2d(nc, shape, rng):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    maps = []
    for _ in range(nc):
        ph = 2 * np.pi * (rng.random() * xx / shape[1]
                          + rng.random() * yy / shape[0])
        amp = 0.4 + np.exp(-(((xx / shape[1]) - rng.random()) ** 2
                             + ((yy / shape[0]) - rng.random()) ** 2) * 3)
        maps.append(amp * np.exp(1j * ph))
    return np.asarray(maps, dtype=np.complex64)


def ellipse_phantom(shape):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    xx = xx / shape[1]
    yy = yy / shape[0]
    img = np.zeros(shape, np.complex64)
    for cx, cy, rx, ry, amp in [(0.5, 0.5, 0.35, 0.45, 1.0),
                                (0.45, 0.5, 0.1, 0.15, -0.5),
                                (0.6, 0.4, 0.08, 0.06, 0.7)]:
        img[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1] += amp
    return img


def radial_problem(n, nc):
    """The radial recipe's operator on the host, its plan, the phantom and
    noisy data (1 % complex noise at the k-space RMS), all from seed 0."""
    from indigo_tpu_torch.models.sense import sense_nufft_op

    rng = np.random.default_rng(SEED)
    traj = radial_traj(int(n * 1.5), 2 * n)
    maps = smooth_maps_2d(nc, (n, n), rng)
    A, plan = sense_nufft_op(traj, maps, oversamp=1.5, width=4,
                             interp="sparse", device="cpu")
    return A, plan, ellipse_phantom((n, n)).ravel()


def add_noise(y, seed):
    """y + 1 % complex white noise at the RMS of y (noise made with numpy)."""
    import torch
    rng = np.random.default_rng(seed)
    sigma = 0.01 * float(torch.sqrt(torch.mean(y.abs() ** 2) / 2))
    noise = (rng.standard_normal(y.shape, dtype=np.float32)
             + 1j * rng.standard_normal(y.shape, dtype=np.float32))
    return y + sigma * torch.from_numpy(noise.astype(np.complex64)).to(
        y.device)


def gridding_leaf(A):
    """(parent module, attribute name, SpMatrix) of the gridding leaf."""
    from indigo_tpu_torch.operators import SpMatrix
    for name, mod in A.named_modules():
        if isinstance(mod, SpMatrix):
            parent, _, attr = name.rpartition(".")
            return A.get_submodule(parent), attr, mod
    raise AssertionError("no SpMatrix in the operator tree")


def reset_counts():
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.dft_cuda import (
        sense_normal_cuda, sense_normal_reference, toeplitz_apply_cuda,
        toeplitz_apply_reference)
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    for fn in (sense_normal_cuda, toeplitz_apply_cuda, jag_spmm_cuda,
               ell_spmm_cuda):
        fn.launches = 0
    sense_normal_reference.cuda_calls = 0
    toeplitz_apply_reference.cuda_calls = 0
    spmm.plain_cuda_calls = 0


def phase_spmm_kernels(ops):
    """K3 and K4 against their plain versions: small shapes, then the
    radial path's matrices. Returns per-kernel worst abs error and times."""
    import copy

    import scipy.sparse as sp
    import torch
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import (
        bell_spmm, csr_to_bell, csr_to_jag, jag_spmm, jag_to_csr)
    from indigo_tpu_torch.utils import rel_err

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    pairs = {"jag": (jag_spmm_cuda, jag_spmm), "bell": (ell_spmm_cuda,
                                                        bell_spmm)}
    rec = {k: {"max_abs_err": 0.0} for k in pairs}

    def check(fmt, mat, x, label, csr=None, **fields):
        t0 = time.time()
        kern, plain = pairs[fmt]
        y = kern(mat, x)
        ref = plain(mat, x)
        torch.cuda.synchronize()
        err = rel_err(y, ref)
        abs_err = float((y - ref).abs().max())
        if not err <= SPMM_TOL:
            raise AssertionError(f"{kern.__name__} vs plain at {label}: "
                                 f"rel_err {err:.3e}")
        if not torch.equal(kern(mat, x), y):
            raise AssertionError(f"{kern.__name__} at {label}: two launches "
                                 "differ")
        rec[fmt]["max_abs_err"] = max(rec[fmt]["max_abs_err"], abs_err)
        length = torch.diff(mat.row_ptr).float()
        fields.update(kernel=kern.__name__, at=label, bm=mat.bm,
                      fill=f"{mat.fill_fraction():.4f}",
                      row_nnz_mean=f"{float(length.mean()):.2f}",
                      row_nnz_max=int(length.max()),
                      heavy_rows=mat.heavy_rows.numel(), bitwise_repeat=True,
                      rel_err=f"{err:.3e}", max_abs_err=f"{abs_err:.3e}")
        if csr is not None:
            # the library route: cuSPARSE on the same matrix as CSR
            A = torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr.astype(np.int32)),
                torch.from_numpy(csr.indices.astype(np.int32)),
                torch.from_numpy(csr.data.astype(np.float32)),
                size=csr.shape).to(dev)

            def library():
                return torch.sparse.mm(A, x)
            lib_err = rel_err(library(), ref)
            if not lib_err <= SPMM_TOL:
                raise AssertionError(f"torch.sparse.mm vs plain at {label}: "
                                     f"rel_err {lib_err:.3e}")
            # kernel and library: card time per call with the host ahead
            # (queued_ms), the kernel's evented wall per call beside it;
            # plain: back to back (ms-scale, hundreds of launches a call)
            p1 = timed(lambda: plain(mat, x), 10)
            k1 = queued_ms(lambda: kern(mat, x), 50)
            lib = queued_ms(library, 50)
            k2 = queued_ms(lambda: kern(mat, x), 50)
            p2 = timed(lambda: plain(mat, x), 10)
            wall = timed(lambda: kern(mat, x), 50)
            b_ms, b_by = spmm_bound(csr, x.shape[1])
            t = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                     library_ms=lib, bound_ms=b_ms, bound_by=b_by)
            fields.update(nnz=csr.nnz, kernel_ms=f"{k1:.4f},{k2:.4f}",
                          plain_ms=f"{p1:.4f},{p2:.4f}",
                          library_ms=f"{lib:.4f}",
                          library_over_kernel=f"{lib / t['ms']:.2f}",
                          kernel_wall_ms_per_call=f"{wall:.4f}",
                          rel_err_library=f"{lib_err:.3e}",
                          bound_ms=f"{b_ms:.5f}", bound_by=b_by,
                          share_of_bound=f"{b_ms / t['ms']:.4f}")
            if mat.heavy_rows.numel():
                # the same kernel with other heavy-row thresholds (none: no
                # row split, every row on one unit), the list derived as
                # sparse.py does: rows over the threshold, longest first
                alt = copy.deepcopy(mat)
                length = torch.diff(mat.row_ptr)
                sweep = []
                for T in (64, 256, None, mat.heavy_nnz):
                    over = length > (T or length.max())
                    rows = torch.nonzero(over).flatten()
                    rows = rows[torch.argsort(-length[rows], stable=True)]
                    alt.heavy_rows, alt.heavy_nnz = rows.int(), T
                    alt_err = rel_err(kern(alt, x), y)
                    if not alt_err <= SPMM_TOL:
                        raise AssertionError(f"{label}: heavy rows over {T} "
                                             f"vs {mat.heavy_nnz}: rel_err "
                                             f"{alt_err:.3e}")
                    sweep.append(f"{T or 'none'}:"
                                 f"{queued_ms(lambda: kern(alt, x), 50):.4f}")
                fields.update(heavy_threshold_ms=",".join(sweep))
                del alt
            return fields, t
        log("spmm", t0, **fields)
        return fields, None

    for m, n, k, dens in [(64, 256, 8, 0.05), (257, 640, 16, 0.01),
                          (40, 1000, 8, 0.001), (300, 129, 7, 0.05),
                          (8, 128, 128, 0.5)]:
        A = sp.random(m, n, density=dens, random_state=rng, format="csr",
                      dtype=np.float32)
        A.data = rng.standard_normal(A.nnz).astype(np.float32)
        x = torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32))
        x = x.to(dev)
        for bm in (8, 16, 128):
            check("jag", csr_to_jag(A, bm=bm).to(dev), x,
                  f"{m}x{n}xK{k}")
            check("bell", csr_to_bell(A, bm=bm).to(dev), x,
                  f"{m}x{n}xK{k}")

    K = 2 * RADIAL_NC  # complex columns of the coil batch, as f32
    _, _, G256 = gridding_leaf(ops[RADIAL_N])
    _, _, G128 = gridding_leaf(ops[128])
    t0 = time.time()
    csr = {"G": jag_to_csr(G256.ell), "GH": jag_to_csr(G256.ellH),
           "GH128": jag_to_csr(G128.ellH)}
    ell256 = csr_to_bell(csr["G"]).to(dev)
    ellH128 = csr_to_bell(csr["GH128"]).to(dev)
    log("spmm_build_ell", t0, G256=f"{ell256.R}x{ell256.W}",
        GH128=f"{ellH128.R}x{ellH128.W}",
        gb=f"{(ell256.memusage() + ellH128.memusage()) / 1e9:.2f}")
    cases = [("jag", G256.ell, f"G {RADIAL_N}^2", csr["G"]),
             ("jag", G256.ellH, f"G^H {RADIAL_N}^2", csr["GH"]),
             ("bell", ell256, f"G-ELL {RADIAL_N}^2", csr["G"]),
             ("bell", ellH128, "G^H-ELL 128^2", csr["GH128"])]
    for fmt, mat, label, A in cases:
        t0 = time.time()
        x = torch.from_numpy(rng.standard_normal(
            (mat.shape[1], K), dtype=np.float32)).to(dev)
        size = (dict(NB=mat.NB) if fmt == "jag"
                else dict(R=mat.R, W=mat.W))
        fields, t = check(fmt, mat, x, label, csr=A, **size)
        log("spmm", t0, **fields)
        # the main path's shapes: G at 256^2, as jag (K3) and as ELL (K4)
        if label.startswith("G ") or label.startswith("G-ELL"):
            rec[fmt].update(t)
    del ell256, ellH128, csr
    torch.cuda.empty_cache()
    return rec


def radial_solve(A, b, maxiter=RADIAL_ITERS, lamda=RADIAL_LAMDA):
    """The recipe's solve: cg(A^H A, b) with history."""
    from indigo_tpu_torch import cg
    return cg(A.H * A, b, lamda=lamda, tol=0.0, maxiter=maxiter,
              history=True)


def radial_small_check():
    """The recipe at 64^2 / 4 coils on the GPU (kernel K3) vs on the CPU
    (plain SpMM): the operator and its adjoint (<= 1e-5), the solve at a
    lamda of 0.3 x the largest eigenvalue of A^H A, where f32 CG is well
    conditioned (<= 1e-4), and the solve at the recipe's lamda 0.1.

    At lamda 0.1 (condition number ~1e7) the 30-step f32 CG amplifies
    rounding: on the CPU alone, perturbing every SpMM output by 6e-8
    relative moves the image by 4e-5 to 4e-4. Two correct implementations
    that sum in another order therefore agree only to that level, and this
    comparison is held to RECIPE_F32_TOL = 2e-3.
    """
    import copy
    import torch
    from indigo_tpu_torch.utils import rel_err

    t0 = time.time()
    A, _, x_true = radial_problem(64, 4)
    Ag = copy.deepcopy(A).to("cuda")
    rng = np.random.default_rng(SEED + 4)
    v = torch.from_numpy(rng.standard_normal(
        (A.shape[1], 2), dtype=np.float32).astype(np.complex64))
    w = torch.from_numpy(rng.standard_normal(
        (A.shape[0], 2), dtype=np.float32).astype(np.complex64))
    op_err = max(rel_err(Ag * v.cuda(), A * v),
                 rel_err(Ag.H * w.cuda(), A.H * w))
    if not op_err <= SPMM_TOL:
        raise AssertionError(f"radial 64^2 operator GPU vs CPU {op_err:.3e}")
    y = add_noise(A * torch.from_numpy(x_true)[:, None], SEED + 2)
    b, bg = A.H * y, Ag.H * y.cuda()
    u = b / torch.linalg.vector_norm(b)
    AHA = A.H * A
    for _ in range(20):
        u = AHA * u
        lmax = float(torch.linalg.vector_norm(u))
        u = u / lmax
    errs = {}
    for key, lam, tol in (("well_conditioned", 0.3 * lmax, PATH_TOL),
                          ("recipe", RADIAL_LAMDA, RECIPE_F32_TOL)):
        xc, _ = radial_solve(A, b, lamda=lam)
        xg, _ = radial_solve(Ag, bg, lamda=lam)
        errs[key] = rel_err(xg, xc)
        if not errs[key] <= tol:
            raise AssertionError(f"radial 64^2 GPU vs CPU ({key}, lamda "
                                 f"{lam:.4g}): rel_err {errs[key]:.3e}")
    log("radial_small", t0, shape="64^2", nc=4,
        op_rel_err_gpu_vs_cpu=f"{op_err:.3e}", lamda_wc=f"{0.3 * lmax:.4g}",
        rel_err_gpu_vs_cpu_wc=f"{errs['well_conditioned']:.3e}",
        rel_err_gpu_vs_cpu_recipe=f"{errs['recipe']:.3e}")


def phase_radial(ops):
    """Main path 2: the 2D radial sparse-gridding CG-SENSE recipe at 256^2
    through K3. Returns the K3 launch count of the run."""
    import torch
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import BlockedJag
    from indigo_tpu_torch.utils import rel_err

    radial_small_check()
    A = ops[RADIAL_N]
    _, _, G = gridding_leaf(A)
    if not (isinstance(G.ell, BlockedJag) and isinstance(G.ellH, BlockedJag)):
        raise AssertionError(f"gridding leaf is {type(G.ell).__name__}")
    x_true = torch.from_numpy(ops["x_true"][RADIAL_N])[:, None].to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    y = add_noise(A * x_true, SEED + 1)
    torch.cuda.synchronize()
    log("radial_simulate", t0, samples=y.shape[0], bm=G.ell.bm,
        NB=G.ell.NB, NB_adj=G.ellH.NB, fill=f"{G.ell.fill_fraction():.4f}")
    t0 = time.time()
    b = A.H * y
    torch.cuda.synchronize()
    t_rhs = time.time() - t0
    log("radial_rhs", t0)
    times = []
    for i in range(2):
        t0 = time.time()
        x, info = radial_solve(A, b)
        res = info["resids"].cpu().numpy()
        x = x.cpu().numpy().ravel()
        times.append(time.time() - t0)
        if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
            raise AssertionError(f"radial solve {i}: residuals {res}")
        if not np.all(np.isfinite(x)):
            raise AssertionError(f"radial solve {i}: image not finite")
        log("radial_solve", t0, index=i, kind="first" if i == 0 else "warm",
            resid_first=f"{res[0]:.4e}", resid_last=f"{res[-1]:.4e}",
            iters=int(info["iters"]),
            rel_err_vs_phantom=f"{rel_err(x, ops['x_true'][RADIAL_N]):.4f}")
    launches = jag_spmm_cuda.launches
    expected = 2 + 2 * (2 + 2 * RADIAL_ITERS)
    if launches != expected:
        raise AssertionError(f"radial path: {launches} K3 launches, "
                             f"expected {expected}")
    if spmm.plain_cuda_calls != 0 or ell_spmm_cuda.launches != 0:
        raise AssertionError("radial path: an SpMM left K3")
    print(f"[radial_summary] rhs_s={t_rhs:.4f} first_s={times[0]:.3f} "
          f"warm_s={times[1]:.3f} "
          f"s_per_iter={times[1] / RADIAL_ITERS:.4f} k3_launches={launches} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
    profile_solve("radial", lambda: radial_solve(A, b), kernel="row_spmm",
                  iters=RADIAL_ITERS)
    return launches


def phase_radial_bell(ops):
    """The 128^2 recipe with a blocked-ELL gridding leaf (K4), against the
    same solve through the jag leaf (K3). Returns the K4 launch count."""
    import torch
    from indigo_tpu_torch.operators import SpMatrix
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda
    from indigo_tpu_torch.sparse import BlockedELL, jag_to_csr
    from indigo_tpu_torch.utils import rel_err

    t0 = time.time()
    A = ops[128]
    x_true = torch.from_numpy(ops["x_true"][128])[:, None].to("cuda")
    y = add_noise(A * x_true, SEED + 3)
    x_jag, _ = radial_solve(A, A.H * y)
    parent, attr, G = gridding_leaf(A)
    Gb = SpMatrix(jag_to_csr(G.ell), name=G.name, format="bell").to("cuda")
    if not isinstance(Gb.ell, BlockedELL):
        raise AssertionError("bell leaf")
    setattr(parent, attr, Gb)  # the same tree, gridding as blocked-ELL
    reset_counts()
    x_bell, info = radial_solve(A, A.H * y)
    torch.cuda.synchronize()
    launches = ell_spmm_cuda.launches
    setattr(parent, attr, G)
    err = rel_err(x_bell, x_jag)
    if not err <= PATH_TOL:
        raise AssertionError(f"128^2 bell vs jag solve rel_err {err:.3e}")
    if launches != 1 + 2 + 2 * RADIAL_ITERS or spmm.plain_cuda_calls:
        raise AssertionError(f"bell path: {launches} K4 launches")
    log("radial_bell", t0, shape="128^2", nc=RADIAL_NC, W=Gb.ell.W,
        W_adj=Gb.ellH.W, k4_launches=launches,
        rel_err_bell_vs_jag=f"{err:.3e}")
    return launches


def build_radial_ops():
    import torch
    ops, x_true = {}, {}
    for n in (RADIAL_N, 128):
        t0 = time.time()
        A, plan, xt = radial_problem(n, RADIAL_NC)
        ops[n] = A.to("cuda")
        x_true[n] = xt
        torch.cuda.synchronize()
        log("radial_init", t0, shape=f"{n}^2", nc=RADIAL_NC,
            samples_per_coil=plan.n_samples,
            grid="x".join(map(str, plan.grid_shape)))
    ops["x_true"] = x_true
    return ops


DCF_ITERS = 20


def phase_toeplitz_kernels():
    """Phase 6a: K2 (toeplitz_apply_cuda) against its plain version on the
    card; times at 128^3 and 256^3 with B = 8 (the 8-coil batch of the
    operator tree). Returns the worst abs error and the times."""
    import torch
    from indigo_tpu_torch.ops.dft_cuda import (
        kernel_spectrum, toeplitz_apply_cuda, toeplitz_apply_reference)
    from indigo_tpu_torch.ops.toeplitz_fft import fft_pad2x, ifft_crop2x
    from indigo_tpu_torch.utils import rand64c, rel_err

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    batch = {(8, 8, 8): 2, (8, 16, 24): 3, (16, 136, 8): 1,
             (24, 136, 40): 2, (8, 256, 16): 2, (128, 128, 128): 8,
             (256, 256, 256): NC}
    worst = 0.0
    timing = {}
    for shape in TOEPLITZ_SHAPES:
        B = batch[shape]
        t0 = time.time()
        Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(
            np.float32)
        T = torch.from_numpy(kernel_spectrum(Tf)).to(dev)
        u = torch.from_numpy(rand64c(B, *shape, rng=rng)).to(dev)
        out = toeplitz_apply_cuda(T, u)
        ref = toeplitz_apply_reference(T, u)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        abs_err = float((out - ref).abs().max())
        del out, ref
        if not err <= KERNEL_TOL:
            raise AssertionError(f"K2 vs plain at {shape} B={B}: rel_err "
                                 f"{err:.3e}")
        worst = max(worst, abs_err)
        fields = dict(shape="x".join(map(str, shape)), B=B,
                      rel_err=f"{err:.3e}", max_abs_err=f"{abs_err:.3e}")
        if shape[0] >= 128:
            T_raw = torch.from_numpy(Tf).to(dev)
            axes = (1, 2, 3)

            def library():
                return ifft_crop2x(T_raw * fft_pad2x(u, axes), axes)
            lib_err = rel_err(library(), toeplitz_apply_cuda(T, u))
            if not lib_err <= KERNEL_TOL:
                raise AssertionError(f"library route vs K2 at {shape}: "
                                     f"rel_err {lib_err:.3e}")
            timing[shape[0]], tf = toeplitz_timing(
                lambda events=None: toeplitz_apply_cuda(T, u, events=events),
                lambda: toeplitz_apply_reference(T, u), library, shape, B, 0,
                toeplitz_apply_cuda)
            fields.update(tf, rel_err_library=f"{lib_err:.3e}")
            del T_raw
        del T, u
        torch.cuda.empty_cache()
        log("toeplitz_kernel", t0, **fields)
    return worst, timing


def tree_recipe(traj, maps, x_true, device, w=None, solves=1,
                noise_free=False):
    """The reference's 3D Toeplitz CG-SENSE recipe through the operator
    tree (examples/multicoil_3d.py): Pipe-Menon DCF, the DCF-weighted
    spectrum, the gridded SENSE operator for the data and the rhs, and
    cg on coils.H * KronI(nc, ToeplitzNormal) * coils. ``w``: DCF weights
    to use instead of computing them; ``solves`` solves of the noisy data,
    then with ``noise_free`` one of the noise-free data. Returns the images,
    residuals, lamda, DCF, spectrum, normal operator, rhs and the seconds
    of each step."""
    import torch
    from indigo_tpu_torch import cg
    from indigo_tpu_torch.models.sense import sense_nufft_op
    from indigo_tpu_torch.noncart import pipe_menon_dcf
    from indigo_tpu_torch.ops.dft_cuda import toeplitz_apply_cuda
    from indigo_tpu_torch.toeplitz import sense_normal_toeplitz, \
        toeplitz_kernel

    img = maps.shape[1:]
    nc = maps.shape[0]
    grid = tuple(int(2 * round(s * OVERSAMP / 2)) for s in img)
    sec = {}

    def lap(key, t0):
        if device == "cuda":
            torch.cuda.synchronize()
        sec[key] = time.time() - t0

    t0 = time.time()
    if w is None:
        w = pipe_menon_dcf(traj, grid, width=WIDTH, iters=DCF_ITERS,
                           device=device)
    lap("dcf_s", t0)
    t0 = time.time()
    Tf, info = toeplitz_kernel(traj, img, oversamp=OVERSAMP, width=WIDTH,
                               weights=w, return_info=True, warn=False,
                               device=device)
    lap("spectrum_s", t0)
    t0 = time.time()
    A, plan = sense_nufft_op(traj, maps, oversamp=OVERSAMP, width=WIDTH,
                             device=device)
    N = sense_normal_toeplitz(Tf, maps, device=device)
    lap("operator_s", t0)
    wd = torch.from_numpy(np.tile(w[plan.perm], nc).astype(np.float32))
    wd = wd[:, None].to(device)
    xt = torch.from_numpy(np.ascontiguousarray(x_true.ravel()))[:, None]
    y0 = A * xt.to(device)
    y = add_noise(y0, SEED)
    t0 = time.time()
    rhs = A.H * (wd * y)
    lap("rhs_s", t0)
    # SenseRecon's rule: 1e-3 |Tf|_max, floored at the gridding error
    eps = 10.0 ** (1 - WIDTH) * (3.0 if OVERSAMP < 1.25 else 1.0)
    lam = max(1e-3 * info["max"], eps * info["max"])
    out = dict(w=w, Tf=Tf, N=N, rhs=rhs, lamda=lam, sec=sec, solve_s=[],
               launches=[])

    def solve(b):
        before = toeplitz_apply_cuda.launches
        t0 = time.time()
        x, cinfo = cg(N, b, lamda=lam, tol=0.0, maxiter=ITERS, history=True)
        res = cinfo["resids"].cpu().numpy()
        out["solve_s"].append(time.time() - t0)
        out["launches"].append(toeplitz_apply_cuda.launches - before)
        if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
            raise AssertionError(f"tree solve at {img}: residuals {res}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"tree solve at {img}: image not finite")
        return x, res

    for _ in range(solves):
        out["x"], out["resids"] = solve(rhs)
    if noise_free:
        out["x_clean"], _ = solve(A.H * (wd * y0))
    return out


def toeplitz_leaf(N):
    from indigo_tpu_torch.toeplitz import ToeplitzNormal
    for mod in N.modules():
        if isinstance(mod, ToeplitzNormal):
            return mod
    raise AssertionError("no ToeplitzNormal in the operator tree")


def phase_tree_path():
    """Phase 6b: the Toeplitz operator-tree recipe at 256^3 / 8 coils.
    Returns the run's state for the cross-checks and its K2 launch count."""
    import torch
    from indigo_tpu_torch import cg
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.dft_cuda import (
        LAUNCHES_PER_CALL, sense_normal_cuda, toeplitz_apply_cuda,
        toeplitz_apply_reference)
    from indigo_tpu_torch.utils import rel_err

    t0 = time.time()
    traj = kooshball_traj(NSPOKES, NREAD, seed=SEED)
    maps = coil_maps(N, NC, seed=SEED)
    x_true = phantom(N)
    log("tree_data", t0, samples_per_coil=len(traj), coils=NC,
        shape=f"{N}^3")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    st = tree_recipe(traj, maps, x_true, "cuda", solves=2, noise_free=True)
    torch.cuda.synchronize()
    launches = toeplitz_apply_cuda.launches
    leaf = toeplitz_leaf(st["N"])
    # the initial residual is one apply
    per_solve = LAUNCHES_PER_CALL * (ITERS + 1)
    if leaf.method != "pallas":
        raise AssertionError(f"tree path Toeplitz method {leaf.method}")
    if st["launches"] != [per_solve] * 3 or launches != 3 * per_solve:
        raise AssertionError(f"tree path K2 launches {st['launches']}, "
                             f"expected {per_solve} per solve")
    if toeplitz_apply_reference.cuda_calls or sense_normal_cuda.launches \
            or spmm.plain_cuda_calls:
        raise AssertionError("tree path left K2 (plain Toeplitz apply, K1 "
                             "or a plain SpMM on the GPU)")
    sec, res = st["sec"], st["resids"]
    x = st["x"].cpu().numpy().reshape(x_true.shape)
    x_clean = st.pop("x_clean").cpu().numpy().reshape(x_true.shape)
    w = st["w"]
    print(f"[tree_summary] dcf_s={sec['dcf_s']:.3f} "
          f"spectrum_s={sec['spectrum_s']:.3f} "
          f"operator_s={sec['operator_s']:.3f} rhs_s={sec['rhs_s']:.4f} "
          f"first_s={st['solve_s'][0]:.3f} warm_s={st['solve_s'][1]:.3f} "
          f"s_per_iter={st['solve_s'][1] / ITERS:.4f} "
          f"lamda={st['lamda']:.4g} resid_first={res[0]:.4e} "
          f"resid_last={res[-1]:.4e} "
          f"rel_err_vs_phantom={rel_err(x, x_true):.4f} "
          f"noise_free_rel_err_vs_phantom={rel_err(x_clean, x_true):.4f} "
          f"noise_free_s={st['solve_s'][2]:.3f} "
          f"dcf_min_max={w.min():.3e},{w.max():.3e} "
          f"k2_launches={launches} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"seconds={time.time() - t0:.3f}", flush=True)
    st["maps"] = maps
    profile_solve("tree", lambda: cg(st["N"], st["rhs"], lamda=st["lamda"],
                                     tol=0.0, maxiter=ITERS, history=True))
    return st, launches


def phase_tree_cross_checks(st):
    """Phase 6c: the tree (K2) against K1 and the GPU against the CPU."""
    import torch
    from indigo_tpu_torch.models import SenseRecon
    from indigo_tpu_torch.noncart import pipe_menon_dcf
    from indigo_tpu_torch.parallel.recon import (
        sense_batch_recon, sense_normal_batched)
    from indigo_tpu_torch.utils import rel_err

    t0 = time.time()
    maps = torch.from_numpy(st["maps"]).to("cuda")
    v = st["rhs"]
    a = st["N"] * v
    b = sense_normal_batched(toeplitz_leaf(st["N"]).T, maps, v.reshape(1, -1),
                             layout="kernel")
    err_apply = rel_err(a[:, 0], b[0])
    del a, b
    xs, _ = sense_batch_recon(torch.from_numpy(st["Tf"]).to("cuda"), maps,
                              v.reshape(1, -1), lamda=st["lamda"],
                              iters=ITERS, coil_chunk=COIL_CHUNK)
    err_solve = rel_err(st["x"][:, 0], xs[0])
    del xs, maps
    for key, err in (("apply", err_apply), ("solve", err_solve)):
        if not err <= PATH_TOL:
            raise AssertionError(f"256^3 tree (K2) vs K1 {key}: rel_err "
                                 f"{err:.3e}")
    log("tree_vs_k1", t0, shape=f"{N}^3", nc=NC,
        rel_err_apply=f"{err_apply:.3e}", rel_err_solve=f"{err_solve:.3e}")

    t0 = time.time()
    n, nc = 32, 4
    traj = kooshball_traj(512, n, seed=SEED)
    maps = coil_maps(n, nc, seed=SEED)
    grid = tuple(int(2 * round(s * OVERSAMP / 2)) for s in (n,) * 3)
    w_dev = pipe_menon_dcf(traj, grid, width=WIDTH, iters=DCF_ITERS,
                           impl="device", device="cuda")
    w = pipe_menon_dcf(traj, grid, width=WIDTH, iters=DCF_ITERS,
                       impl="host")
    err_w = rel_err(w_dev, w)
    gpu = tree_recipe(traj, maps, phantom(n), "cuda", w=w)
    cpu = tree_recipe(traj, maps, phantom(n), "cpu", w=w)
    err_x = rel_err(gpu["x"], cpu["x"])
    kw = dict(oversamp=OVERSAMP, width=WIDTH, iters=ITERS, coil_chunk=2,
              dcf="pipe_menon")
    rg = SenseRecon(traj, maps, device="cuda", **kw)
    rc = SenseRecon(traj, maps, device="cpu", **kw)
    y = rg.simulate(phantom(n))
    err_sr = rel_err(rg(y), rc(y))
    for key, err in (("dcf device vs host", err_w), ("tree recipe", err_x),
                     ("SenseRecon pipe_menon", err_sr)):
        if not err <= PATH_TOL:
            raise AssertionError(f"32^3 GPU vs CPU {key}: rel_err {err:.3e}")
    log("tree_small", t0, shape=f"{n}^3", nc=nc,
        rel_err_dcf_device_vs_host=f"{err_w:.3e}",
        rel_err_tree_gpu_vs_cpu=f"{err_x:.3e}",
        rel_err_senserecon_pipe_menon_gpu_vs_cpu=f"{err_sr:.3e}")

CART_ITERS, FISTA_ITERS, EIGEN_ITERS = 10, 30, 30
FISTA_LAM_FRACTION = 0.002  # lam as a fraction of max |W A^H y|


def leaf_kinds(op):
    from indigo_tpu_torch.operators import Operator
    return sorted({type(m).__name__ for m in op.modules()
                   if isinstance(m, Operator) and not m.children()})


def host_peak_gb():
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def cartesian_example_problem(n):
    """make_problem of examples/cartesian_sense_2d.py: the sampling matrix
    P (every 2nd row plus the centre quarter), the smooth diagonal d and
    the ellipse phantom."""
    import scipy.sparse as sp
    keep = np.zeros(n, dtype=bool)
    keep[::2] = True
    keep[n // 2 - n // 8: n // 2 + n // 8] = True
    rows = np.flatnonzero(np.repeat(keep, n))
    P = sp.csr_matrix(
        (np.ones(len(rows), np.float32), (np.arange(len(rows)), rows)),
        shape=(len(rows), n * n))
    yy, xx = np.mgrid[0:n, 0:n] / n
    d = (0.5 + np.exp(-((xx - 0.5) ** 2 + (yy - 0.5) ** 2) * 4)).astype(
        np.complex64)
    return P, d.ravel(), ellipse_phantom((n, n)).ravel()


def example_float64(P, d, n):
    """The example's operator A = P F diag(d) in float64 numpy, and A^+ =
    A^H (A A^H)^-1 (A has full row rank and A A^H the condition
    (max|d| / min|d|)^2 <= 9, so float64 CG inverts it to rounding).
    A^+ A is the orthogonal projector onto range(A^H), A^+ y the
    minimum-norm solution: what cg from x0 = 0 gives in exact arithmetic,
    and the lamda -> 0 limit of the regularized one."""
    from indigo_tpu_torch import oracle
    P64, d64 = P.astype(np.float64), d.astype(np.complex128)

    def A(x):
        return P64 @ np.fft.fftn((d64 * x).reshape(n, n)).ravel()

    def AH(y):
        return np.conj(d64) * (n * n) * np.fft.ifftn(
            (P64.T @ y).reshape(n, n)).ravel()

    def pinv(y):
        z, _ = oracle.cg(lambda v: A(AH(v)), y, tol=1e-14, maxiter=200)
        return AH(z)

    return A, pinv


def cartesian_example_solve(pkg, P, d, x_true, n, lam_posed, **device):
    """The example's recipe with package ``pkg`` (``device=``: where the
    port builds its leaves):
    A = (SpMatrix(P) * UnscaledFFT * Diag(d)).optimize(), y = A x,
    AHA = (A.H * A).optimize(), cg(AHA, A.H y, lamda=1e-6, tol=1e-8,
    maxiter=100); then the same system at ``lam_posed``. Returns the two
    images (numpy), the iterations and AHA."""
    A = (pkg.SpMatrix(P, **device) * pkg.UnscaledFFT((n, n), **device)
         * pkg.Diag(d, **device)).optimize()
    y = A * x_true
    AHA = (A.H * A).optimize()
    rhs = A.H * y
    x, info = pkg.cg(AHA, rhs, lamda=1e-6, tol=1e-8, maxiter=100)
    xr, _ = pkg.cg(AHA, rhs, lamda=lam_posed, tol=1e-8, maxiter=100)
    host = (lambda t: t.cpu().numpy()) if hasattr(x, "cpu") else np.asarray
    return host(x), host(xr), int(info["iters"]), AHA


def range_part(x, y64, x_mn, A64, pinv):
    """Readings of one f32 image x of the example's singular system against
    the float64 witness: data consistency |A x - y| / |y|; |x| over the norm
    of its part in range(A^H); that part against the minimum-norm solution;
    and the bar it is held to. x is stored in f32, so its range part carries
    eps32 |x| of rounding from storage alone: the bar is PATH_TOL, or twice
    that rounding where the null-space part makes it larger."""
    from indigo_tpu_torch.utils import rel_err
    x = np.asarray(x, np.complex128).ravel()
    px = pinv(A64(x))
    ratio = float(np.linalg.norm(x) / np.linalg.norm(px))
    bar = max(PATH_TOL, 2 * float(np.finfo(np.float32).eps) * ratio)
    return {"dc": rel_err(A64(x), y64), "ratio": ratio, "px": px,
            "err": rel_err(px, x_mn), "bar": bar}


def cartesian_small_check():
    """The config-1 recipe as the example writes it, at 128^2, on the GPU
    and on the CPU (``cartesian_example_solve``).

    The example's system is singular (one coil, undersampled) and its
    lamda 1e-6 lies under f32 rounding of a spectrum of ~3.7e4, so each f32
    image carries a null-space part that rounding decides and 1 / lamda
    amplifies; the example itself asserts data consistency only. What the
    data determine is the part in range(A^H). So each device is held to the
    example's data-consistency bar, and its range part (projected in
    float64, ``example_float64``) to the float64 minimum-norm solution and
    to the other device's (``range_part`` states the bar). The whole images
    are compared where the solution is unique: lamda at 1e-2 of the largest
    eigenvalue n^2 max|d|^2."""
    import indigo_tpu_torch as it
    from indigo_tpu_torch.utils import rel_err

    t0 = time.time()
    n = 128
    P, d, x_true = cartesian_example_problem(n)
    lam = 1e-2 * n * n * float(np.abs(d).max()) ** 2
    A64, pinv = example_float64(P, d, n)
    y64 = A64(x_true.astype(np.complex128))
    x_mn = pinv(y64)
    out, read = {}, {}
    for dev in ("cuda", "cpu"):
        x, xr, iters, AHA = cartesian_example_solve(
            it, P, d, x_true, n, lam, device=dev)
        if "SpMatrix" in leaf_kinds(AHA):
            raise AssertionError(f"128^2 example recipe on {dev}: P^H P did "
                                 f"not fuse: {leaf_kinds(AHA)}")
        r = read[dev] = range_part(x, y64, x_mn, A64, pinv)
        if not r["dc"] < 1e-3:
            raise AssertionError(f"128^2 example recipe on {dev}: data "
                                 f"consistency {r['dc']:.3e}")
        if not r["err"] <= r["bar"]:
            raise AssertionError(
                f"128^2 example recipe on {dev}: range part vs the float64 "
                f"minimum-norm solution {r['err']:.3e} > {r['bar']:.3e}")
        out[dev] = (x, xr, iters)
    err_raw = rel_err(out["cuda"][0], out["cpu"][0])
    err_range = rel_err(read["cuda"]["px"], read["cpu"]["px"])
    bar = read["cuda"]["bar"] + read["cpu"]["bar"]
    if not err_range <= bar:
        raise AssertionError(f"128^2 example recipe: range parts GPU vs CPU "
                             f"{err_range:.3e} > {bar:.3e}")
    err = rel_err(out["cuda"][1], out["cpu"][1])
    if not err <= PATH_TOL:
        raise AssertionError(f"128^2 example recipe, lamda={lam:.4g}: GPU vs "
                             f"CPU {err:.3e}")
    fields = {}
    for dev, key in (("cuda", "gpu"), ("cpu", "cpu")):
        r = read[dev]
        fields[f"data_consistency_{key}"] = f"{r['dc']:.3e}"
        fields[f"norm_over_range_part_{key}"] = f"{r['ratio']:.1f}"
        fields[f"range_part_vs_float64_{key}"] = f"{r['err']:.3e}"
        fields[f"bar_{key}"] = f"{r['bar']:.3e}"
    log("cartesian_small", t0, shape="128^2", iters=out["cuda"][2],
        rel_err_images_gpu_vs_cpu=f"{err_raw:.3e}",
        rel_err_range_parts_gpu_vs_cpu=f"{err_range:.3e}",
        lamda_compared=f"{lam:.4g}", rel_err_gpu_vs_cpu=f"{err:.3e}",
        **fields)


def phase_cartesian(maps, x_true):
    """Phase 7: Cartesian CG-SENSE through the tree optimizer at 256^3 / 8
    coils. No hand-written kernel is on this path. Returns
    ``profiling.roofline_report`` of one apply of its A (read in phase
    10)."""
    import torch
    from indigo_tpu_torch import cg, max_eigen, transforms
    from indigo_tpu_torch.models import cartesian_sense_op
    from indigo_tpu_torch.utils import rel_err

    cartesian_small_check()
    t0 = time.time()
    m2 = np.zeros((N, N), bool)
    m2[::2, ::2] = True
    c = N // 2
    m2[c - 16:c + 16, c - 16:c + 16] = True
    mask = np.broadcast_to(m2, (N, N, N))
    kept = NC * int(mask.sum())
    if kept > transforms.MAX_KRON_NNZ:
        raise AssertionError(f"{kept} kept samples over {NC} coils exceed "
                             f"the fusion's cap {transforms.MAX_KRON_NNZ}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    A = cartesian_sense_op(mask, maps)      # on the card by default
    assert_on_card(A)
    y = add_noise(A * np.ascontiguousarray(x_true.ravel())[:, None],
                  SEED + 6)
    torch.cuda.synchronize()
    log("cartesian_init", t0, shape=f"{N}^3", nc=NC,
        sampled_fraction=f"{mask.mean():.4f}", kept_samples=kept,
        cap=transforms.MAX_KRON_NNZ)

    t0 = time.time()
    host_before = host_peak_gb()
    AHA = A.H * A
    Nop = AHA.optimize()
    torch.cuda.synchronize()
    t_opt = time.time() - t0
    kinds = leaf_kinds(Nop)
    if "Mask" in kinds or any(b.device != A.device for b in Nop.buffers()):
        raise AssertionError(f"optimize left {kinds} (or moved a buffer "
                             f"off {A.device})")
    log("cartesian_optimize", t0, leaves=",".join(kinds),
        host_peak_gb_before=f"{host_before:.2f}",
        host_peak_gb_after=f"{host_peak_gb():.2f}",
        tree_mb=f"{Nop.memusage() / 1e6:.0f}")
    print(Nop.dump(), flush=True)

    t0 = time.time()
    rng = np.random.default_rng(SEED + 7)
    v = torch.from_numpy(rng.standard_normal(
        (A.shape[1], 1), dtype=np.float32).astype(np.complex64)).to("cuda")
    err_apply = rel_err(Nop * v, AHA * v)
    if not err_apply <= 1e-5:
        raise AssertionError(f"optimized N vs A.H * A: rel_err "
                             f"{err_apply:.3e}")
    rhs = A.H * y
    eig = max_eigen(Nop, A.shape[1], iters=10)
    # the reference's call form: a numpy dtype
    eig_np = max_eigen(Nop, A.shape[1], iters=10, dtype=np.complex64)
    err_eig = abs(float(eig_np) - float(eig)) / abs(float(eig))
    if not (eig_np.is_cuda and err_eig <= 1e-6):
        raise AssertionError(f"max_eigen(dtype=np.complex64) vs "
                             f"torch.complex64: {eig_np.device}, rel "
                             f"{err_eig:.3e}")
    lam = 1e-3 * float(eig)
    torch.cuda.synchronize()
    log("cartesian_apply", t0, rel_err_optimized_vs_tree=f"{err_apply:.3e}",
        lamda=f"{lam:.4g}", card=repr(card_line()),
        max_eigen_numpy_dtype_rel=f"{err_eig:.3e}",
        max_eigen_numpy_dtype_bitwise=bool(torch.equal(eig_np, eig)))

    def solve(op):
        return cg(op, rhs, lamda=lam, tol=0.0, maxiter=CART_ITERS,
                  history=True)

    times = []
    for i in range(2):
        t0 = time.time()
        x, info = solve(Nop)
        res = info["resids"].cpu().numpy()
        times.append(time.time() - t0)
        if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
            raise AssertionError(f"cartesian solve {i}: residuals {res}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"cartesian solve {i}: image not finite")
    t0 = time.time()
    solve(AHA)
    torch.cuda.synchronize()
    t_tree = time.time() - t0
    err_img = rel_err(x.cpu().numpy().reshape(x_true.shape), x_true)
    assert_no_kernel_launch("cartesian")
    print(f"[cartesian_summary] optimize_s={t_opt:.3f} "
          f"first_s={times[0]:.3f} warm_s={times[1]:.3f} "
          f"s_per_iter={times[1] / CART_ITERS:.4f} "
          f"unoptimized_warm_s={t_tree:.3f} lamda={lam:.4g} "
          f"resid_first={res[0]:.4e} resid_last={res[-1]:.4e} "
          f"rel_err_vs_phantom={err_img:.4f} "
          f"bytes_floor_ms_per_apply="
          f"{Nop.cost(1)[1] / HBM_BYTES_PER_S * 1e3:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
    print(f"[cartesian_parts] N_apply_ms={timed(lambda: Nop * v, 5):.3f} "
          f"tree_apply_ms={timed(lambda: AHA * v, 5):.3f} "
          f"A_ms={timed(lambda: A * v, 5):.3f} "
          f"A.H_ms={timed(lambda: A.H * y, 5):.3f}", flush=True)
    profile_solve("cartesian", lambda: solve(Nop))
    from indigo_tpu_torch.profiling import roofline_report
    return roofline_report(A, ncols=1)


def assert_on_card(*ops):
    """These operators were built with no device argument: they must be
    on the GPU."""
    for op in ops:
        if not all(b.is_cuda for b in op.buffers()):
            raise AssertionError(f"{op.name} was not built on the GPU")


def assert_no_kernel_launch(path):
    """The Cartesian and FISTA paths are torch code: no K1-K4 launch and no
    plain version of one on the GPU."""
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.dft_cuda import (
        sense_normal_cuda, sense_normal_reference, toeplitz_apply_cuda,
        toeplitz_apply_reference)
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    n = (sense_normal_cuda.launches + toeplitz_apply_cuda.launches
         + jag_spmm_cuda.launches + ell_spmm_cuda.launches
         + sense_normal_reference.cuda_calls
         + toeplitz_apply_reference.cuda_calls + spmm.plain_cuda_calls)
    if n:
        raise AssertionError(f"{path} path: {n} kernel or plain-kernel "
                             "calls, expected none")


def vardens_rows(n, accel, center, rng):
    """The example's 1-D variable-density row mask (vardens_mask)."""
    p = 1.0 / (1.0 + 40.0 * np.abs(np.linspace(-0.5, 0.5, n)))
    p = p / p.mean() / accel
    rows = rng.random(n) < p
    rows[int(n * (0.5 - center / 2)):int(n * (0.5 + center / 2))] = True
    return rows


def fista_recipe(A, W, y, lam, L, iters, objective=True):
    """The example's FISTA in the wavelet domain (u = W x): returns
    (u, info)."""
    import torch
    from indigo_tpu_torch import apgd, soft_thresh

    def gradf(u):
        r = A.apply(W.apply(u, adjoint=True)) - y
        return W.apply(A.apply(r, adjoint=True))

    def obj(u):
        r = A.apply(W.apply(u, adjoint=True)) - y
        return (0.5 * torch.linalg.vector_norm(r) ** 2
                + lam * u.abs().sum())

    u0 = torch.zeros((A.shape[1], 1), dtype=torch.complex64, device=y.device)
    return apgd(gradf, lambda v, a: soft_thresh(v, lam * a), 1.0 / L, u0,
                maxiter=iters, history=objective,
                objective=obj if objective else None)


def zero_filled_error(A, y, nc, x_true):
    """The example's zero-filled yardstick: A^H y / nc scaled to the
    phantom's peak, and its distance from the phantom."""
    from indigo_tpu_torch.utils import rel_err
    x_zf = (A.H * y)[:, 0].cpu().numpy() / nc
    return rel_err(x_zf / max(abs(x_zf).max(), 1e-9) * abs(x_true).max(),
                   x_true)


def fista_small_check():
    """The config-4 example's defaults (128^2, 4 coils, lam 2e-3, 100
    iterations) on the GPU and on the CPU."""
    import torch
    import indigo_tpu_torch as it
    from indigo_tpu_torch.models import cartesian_sense_op
    from indigo_tpu_torch.utils import rand64c, rel_err

    t0 = time.time()
    n, nc, lam, iters = 128, 4, 2e-3, 100
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:n, 0:n] / n
    maps = np.asarray([
        (0.5 + np.exp(-(((xx - a) ** 2 + (yy - b) ** 2) * 3)))
        * np.exp(1j * 2 * np.pi * (a * xx + b * yy))
        for a, b in [(0.3, 0.3), (0.3, 0.7), (0.7, 0.3), (0.7, 0.7)][:nc]],
        dtype=np.complex64)
    mask = np.zeros((n, n), bool)
    mask[vardens_rows(n, 3, 0.08, rng)] = True
    img = ellipse_phantom((n, n))
    img[((xx - 0.35) / 0.05) ** 2 + ((yy - 0.6) / 0.09) ** 2 <= 1] += 0.5
    x_true = img.ravel()
    A = cartesian_sense_op(mask, maps, device="cpu")
    y = A * x_true[:, None]
    y = y + 0.01 * float(y.abs().mean()) * torch.from_numpy(
        rand64c(*y.shape, rng=rng))
    out = {}
    for dev in ("cuda", "cpu"):
        Ad = cartesian_sense_op(mask, maps, device=dev)
        Wd = it.DWT((n, n), wavelet="db4", levels=3, device=dev)
        yd = y.to(dev)
        L = float(it.max_eigen(Ad.H * Ad, n * n, iters=30)) * 1.05
        u, _ = fista_recipe(Ad, Wd, yd, lam, L, iters, objective=False)
        out[dev] = ((Wd.H * u)[:, 0].cpu().numpy(), L)
    err = rel_err(out["cuda"][0], out["cpu"][0])
    err_cs = rel_err(out["cuda"][0], x_true)
    err_zf = zero_filled_error(A, y, nc, x_true)
    if not err <= PATH_TOL:
        raise AssertionError(f"128^2 FISTA example GPU vs CPU {err:.3e}")
    if not (err_cs < err_zf and err_cs < 0.25):     # the example's asserts
        raise AssertionError(f"128^2 FISTA example: CS {err_cs:.3f} vs "
                             f"zero-filled {err_zf:.3f}")
    log("fista_small", t0, shape="128^2", nc=nc, iters=iters,
        L_gpu=f"{out['cuda'][1]:.1f}", L_cpu=f"{out['cpu'][1]:.1f}",
        rel_err_gpu_vs_cpu=f"{err:.3e}", rel_err_cs=f"{err_cs:.3f}",
        rel_err_zero_filled=f"{err_zf:.3f}")


def phase_fista(maps, x_true):
    """Phase 8: l1-wavelet FISTA at 256^3 / 8 coils. No hand-written kernel
    is on this path."""
    import torch
    import indigo_tpu_torch as it
    from indigo_tpu_torch.models import cartesian_sense_op
    from indigo_tpu_torch.utils import rel_err

    fista_small_check()
    t0 = time.time()
    rng = np.random.default_rng(SEED)
    p1 = 1.0 / (1.0 + 40.0 * np.abs(np.linspace(-0.5, 0.5, N)))
    p2 = np.multiply.outer(p1, p1)
    p2 = np.minimum(p2 / p2.mean() / 6.0, 1.0)
    m2 = rng.random((N, N)) < p2
    c = N // 2
    m2[c - 12:c + 12, c - 12:c + 12] = True
    mask = np.broadcast_to(m2, (N, N, N))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    A = cartesian_sense_op(mask, maps)      # both on the card by default
    W = it.DWT((N, N, N), wavelet="db4", levels=3)
    assert_on_card(A, W)
    y = A * np.ascontiguousarray(x_true.ravel())[:, None]
    noise = rng.standard_normal((2,) + tuple(y.shape), dtype=np.float32)
    y = y + 0.01 * float(y.abs().mean()) * torch.from_numpy(
        noise[0] + 1j * noise[1]).to("cuda")
    del noise
    torch.cuda.synchronize()
    log("fista_init", t0, shape=f"{N}^3", nc=NC,
        sampled_fraction=f"{mask.mean():.4f}",
        undersampling=f"{1 / mask.mean():.2f}",
        samples_per_coil=int(mask.sum()), wavelet="db4", levels=W.levels)

    t0 = time.time()
    n = A.shape[1]
    L = 1.05 * float(it.max_eigen(A.H * A, n, iters=EIGEN_ITERS))
    t_eigen = time.time() - t0
    lam = FISTA_LAM_FRACTION * float((W * (A.H * y)).abs().max())
    log("fista_step", t0, L=f"{L:.6g}", lam=f"{lam:.6g}",
        threshold_per_step=f"{lam / L:.4g}", eigen_iters=EIGEN_ITERS)

    times = []
    for i in range(2):
        t0 = time.time()
        u, info = fista_recipe(A, W, y, lam, L, FISTA_ITERS)
        objs = info["objs"].cpu().numpy()
        deltas = info["deltas"].cpu().numpy()
        times.append(time.time() - t0)
        if not (np.all(np.isfinite(objs)) and np.all(np.isfinite(deltas))
                and bool(torch.isfinite(u).all())):
            raise AssertionError(f"FISTA run {i}: not finite")
        # FISTA is not a descent method step by step (the momentum may
        # overshoot), so the largest single rise is printed and held small,
        # and the objective must fall over the run and over its second half
        rise = float(np.max(np.diff(objs) / objs[:-1]))
        half = objs[len(objs) // 2]
        slack = 1 + 1e-5        # f32 sums of ~1e8 terms, once converged
        if not (objs[-1] <= half * slack and half <= objs[0]
                and rise <= 1e-3):
            raise AssertionError(
                f"FISTA run {i}: objective {objs[0]:.6g} -> {half:.6g} -> "
                f"{objs[-1]:.6g}, largest relative rise {rise:.3e}")
        if int(info["iters"]) != FISTA_ITERS:
            raise AssertionError(f"FISTA run {i}: {int(info['iters'])} "
                                 "iterations")
    t0 = time.time()
    fista_recipe(A, W, y, lam, L, FISTA_ITERS, objective=False)
    torch.cuda.synchronize()
    t_plain = time.time() - t0
    x_cs = (W.H * u)[:, 0].cpu().numpy()
    err_cs = rel_err(x_cs, x_true.ravel())
    err_zf = zero_filled_error(A, y, NC, x_true.ravel())
    if not (np.all(np.isfinite(x_cs)) and err_cs < err_zf):
        raise AssertionError(f"FISTA image {err_cs:.4f} from the phantom, "
                             f"zero-filled {err_zf:.4f}")
    assert_no_kernel_launch("FISTA")
    # bytes floor of one iteration: W.H, A, A.H, W once each (the recorded
    # runs also evaluate the objective: W.H and A once more)
    grad_bytes = 2 * (A.cost(1)[1] + W.cost(1)[1])
    floor = grad_bytes / HBM_BYTES_PER_S * 1e3
    floor_obj = 1.5 * floor
    sparsity = float((u != 0).float().mean())
    print(f"[fista_summary] L={L:.6g} lam={lam:.6g} eigen_s={t_eigen:.3f} "
          f"first_s={times[0]:.3f} warm_s={times[1]:.3f} "
          f"s_per_iter={times[1] / FISTA_ITERS:.4f} "
          f"bytes_floor_ms_per_iter={floor_obj:.3f} "
          f"no_objective_warm_s={t_plain:.3f} "
          f"no_objective_s_per_iter={t_plain / FISTA_ITERS:.4f} "
          f"no_objective_bytes_floor_ms_per_iter={floor:.3f} "
          f"obj_first={objs[0]:.6g} obj_mid={half:.6g} "
          f"obj_last={objs[-1]:.6g} obj_largest_rise={rise:.3e} "
          f"delta_last={deltas[-1]:.4g} nonzero_coefficients={sparsity:.4f} "
          f"rel_err_cs={err_cs:.4f} rel_err_zero_filled={err_zf:.4f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
    # the iteration's parts, one by one, each beside its cost() bytes floor
    from indigo_tpu_torch import soft_thresh
    parts = (("W", W, False, u), ("W.H", W, True, u),
             ("A", A, False, u), ("A.H", A, True, y))
    fields = []
    for key, op, adj, v in parts:
        ms = timed(lambda: op.apply(v, adjoint=adj), 5)
        fields.append(f"{key}_ms={ms:.3f} {key}_bytes_floor_ms="
                      f"{op.cost(1)[1] / HBM_BYTES_PER_S * 1e3:.3f}")
    ms = timed(lambda: soft_thresh(u, lam / L), 5)
    fields.append(f"soft_thresh_ms={ms:.3f} soft_thresh_bytes_floor_ms="
                  f"{2 * u.numel() * 8 / HBM_BYTES_PER_S * 1e3:.3f}")
    print("[fista_parts] " + " ".join(fields), flush=True)
    profile_solve("fista", lambda: fista_recipe(A, W, y, lam, L, FISTA_ITERS,
                                                objective=False))


SHARDED_RANKS, SHARDED_TIMEOUT = 4, 700.0
FFT_TOL = 1e-5


def _timed_solves(mesh, solve, iters):
    """Run ``solve`` twice (first, warm) on this rank: seconds per solve,
    and from the mesh's counters the warm solve's collective seconds and
    bytes sent. Returns (last result, fields)."""
    import torch
    secs, stats = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        before = dict(mesh.stats)
        t0 = time.time()
        out = solve()
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        stats.append({k: None if mesh.stats[k] is None
                      else mesh.stats[k] - before[k] for k in before})
    warm = stats[1]
    return out, _solve_fields(secs, warm, iters)


def _solve_fields(secs, warm, iters):
    """The readings of a timed pair of solves; the collectives' seconds are
    "n/a" on a transport the host cannot time (``stats["seconds"]`` None)."""
    timed = warm["seconds"] is not None
    return dict(
        first_s=secs[0], warm_s=secs[1], s_per_iter=secs[1] / iters,
        bytes_sent_per_rank_per_iter=warm["bytes_sent"] / iters,
        collectives_per_solve=warm["calls"],
        collective_s=warm["seconds"] if timed else "n/a",
        collective_share=warm["seconds"] / secs[1] if timed else "n/a")


def _check_solve(label, x, x_ref, res, tol=PATH_TOL):
    import torch
    from indigo_tpu_torch.utils import rel_err
    res = np.asarray(res.cpu() if torch.is_tensor(res) else res)
    if not (np.all(np.isfinite(res)) and np.all(res[-1] < res[0])):
        raise AssertionError(f"{label}: residuals {res}")
    err = rel_err(x, x_ref)
    if not err <= tol:
        raise AssertionError(f"{label} vs the single-device answer: "
                             f"rel_err {err:.3e}")
    return dict(rel_err_vs_single_device=err,
                resid_first=float(res[0].max()),
                resid_last=float(res[-1].max()))


def sharded_ranks(workdir, lamda):
    """What each of the 4 ranks that share the card runs in phase 9. The
    global arrays come from ``workdir`` (written by ``phase_sharded``);
    returns rank 0's readings."""
    import torch
    from indigo_tpu_torch.ops import _build
    from indigo_tpu_torch.ops.dft_cuda import (
        LAUNCHES_PER_CALL, sense_normal_cuda, sense_normal_reference)
    from indigo_tpu_torch.parallel import (
        SenseReconSharded, fftn_sharded, fftn_sharded2, make_mesh,
        sense_batch_recon, sense_vol_recon, sense_vol_recon2)
    from indigo_tpu_torch.parallel import collectives as C
    from indigo_tpu_torch.utils import rand64c, rel_err

    if not os.path.exists(os.path.join(_build.build_dir(),
                                       "libindigo_kernels.so")):
        raise AssertionError("the ranks build nothing: phase 1 must have "
                             "built the kernel library")
    dev = torch.device("cuda", torch.cuda.current_device())

    def load(name, device=dev):
        a = np.load(os.path.join(workdir, name + ".npy"), mmap_mode="r")
        return a if device is None else torch.from_numpy(
            np.array(a)).to(device)

    out = {"transport": None}
    peak = {}

    def peak_gb(key):
        # the largest of the ranks' peaks since the last reset
        mine = torch.tensor([torch.cuda.max_memory_allocated() / 1e9])
        peak[key] = float(C.gather_blocks(mine, world, world.group()).max())
        torch.cuda.reset_peak_memory_stats()

    # (d) the distributed FFT, slab and pencil
    world = make_mesh(x=SHARDED_RANKS)
    out["transport"] = C.transport(world)
    pencil = make_mesh(x=2, y=2)
    v = torch.from_numpy(rand64c(N, N, N, rng=SEED + 9)).to(dev)
    fft = {}
    for inverse in (False, True):
        want = (torch.fft.ifftn if inverse else torch.fft.fftn)(v)
        for key, got in (
                ("slab", lambda: fftn_sharded(v, world, "x", inverse=inverse)),
                ("pencil", lambda: fftn_sharded2(v, pencil,
                                                 inverse=inverse))):
            torch.cuda.synchronize()
            t0 = time.time()
            res = got()
            torch.cuda.synchronize()
            name = key + ("_inverse" if inverse else "")
            fft[name] = (rel_err(res, want), time.time() - t0)
            if not fft[name][0] <= FFT_TOL:
                raise AssertionError(f"fftn_sharded {name} vs torch.fft: "
                                     f"rel_err {fft[name][0]:.3e}")
            del res
        del want
    del v
    out["fft"] = fft
    pencil.close()
    peak_gb("fft")

    Tf, maps, rhs = load("Tf"), load("maps"), load("rhs")
    x_ref = load("x_ref")                                   # (2, n)

    # (a) slices x coils: K1 on every rank's (1 slice, 4 coils) block
    mesh = make_mesh(slice=2, coil=2)
    sense_normal_cuda.launches = 0
    sense_normal_reference.cuda_calls = 0
    (xs, res), fields = _timed_solves(
        mesh, lambda: sense_batch_recon(Tf, maps, rhs, mesh=mesh,
                                        lamda=lamda, iters=ITERS,
                                        coil_chunk=COIL_CHUNK), ITERS)
    counts = C.gather_blocks(torch.tensor(
        [sense_normal_cuda.launches, sense_normal_reference.cuda_calls]),
        world, world.group()).cpu().numpy()
    per_solve = LAUNCHES_PER_CALL * ITERS      # 4 local coils, one chunk
    if not (np.all(counts[:, 0] == 2 * per_solve)
            and np.all(counts[:, 1] == 0)):
        raise AssertionError(
            f"(a) K1 launches / plain normal-op calls per rank {counts}, "
            f"expected {2 * per_solve} / 0")
    fields.update(_check_solve("(a) sense_batch_recon(mesh)", xs, x_ref,
                               res))
    fields["k1_launches_per_rank"] = counts[:, 0].tolist()
    out["batch"] = fields
    del xs
    mesh.close()
    peak_gb("batch")

    # (b) one volume in z slabs, then in (z, y) pencils
    vol = rhs[0].reshape(N, N, N)
    slab = make_mesh(vol=SHARDED_RANKS)
    (x, res), fields = _timed_solves(
        slab, lambda: sense_vol_recon(Tf, maps, vol, slab, lamda=lamda,
                                      iters=ITERS), ITERS)
    fields.update(_check_solve("(b) sense_vol_recon", x.ravel(), x_ref[0],
                               res))
    out["slab"] = fields
    del x
    peak_gb("slab")
    pen = make_mesh(vz=2, vy=2)
    (x, res), fields = _timed_solves(
        pen, lambda: sense_vol_recon2(Tf, maps, vol, pen, lamda=lamda,
                                      iters=ITERS), ITERS)
    fields.update(_check_solve("(b) sense_vol_recon2", x.ravel(), x_ref[0],
                               res))
    out["pencil"] = fields
    if sense_normal_cuda.launches != 2 * per_solve:
        raise AssertionError("the volume-sharded solves launched K1")
    del x, Tf, maps, rhs, vol
    pen.close()
    torch.cuda.empty_cache()
    peak_gb("pencil")

    # (c) k-space in, image out
    t0 = time.time()
    rec = SenseReconSharded(kooshball_traj(NSPOKES, NREAD, seed=SEED),
                            load("maps", None), slab, dcf="radial",
                            oversamp=OVERSAMP, width=WIDTH, iters=ITERS)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    grid = tuple(int(2 * round(N * OVERSAMP / 2)) for _ in range(3))
    if rec.grid_shape != grid or abs(rec.lamda / lamda - 1) > 1e-5:
        raise AssertionError(
            f"(c) grid {rec.grid_shape} (single device {grid}), lamda "
            f"{rec.lamda} (single device {lamda})")
    y = load("y", None)
    (x, res), fields = _timed_solves(
        slab, lambda: rec(y, return_resids=True), ITERS)
    fields.update(_check_solve("(c) SenseReconSharded", x,
                               load("x_e2e", None), res), init_s=init_s)
    out["e2e"] = fields
    peak_gb("e2e")
    out["peak_gb"] = peak
    slab.close()
    world.close()
    return out


def nccl_one_rank():
    """Phase 9 (e): one rank over NCCL at 64^3."""
    import torch
    from indigo_tpu_torch.ops.dft_cuda import sense_normal_cuda
    from indigo_tpu_torch.parallel import (
        make_mesh, sense_batch_recon, sense_vol_recon, sense_vol_recon2)
    from indigo_tpu_torch.parallel import collectives as C
    from indigo_tpu_torch.toeplitz import toeplitz_kernel
    from indigo_tpu_torch.utils import rand64c, rel_err

    n, nc = 64, 4
    traj = kooshball_traj(1024, n, seed=SEED)
    maps = torch.from_numpy(coil_maps(n, nc, seed=SEED)).cuda()
    Tf = toeplitz_kernel(traj, (n, n, n), oversamp=OVERSAMP, width=WIDTH,
                         warn=False, device="cuda")
    lam = 0.05 * float(np.abs(Tf).max())
    Tf = torch.from_numpy(Tf).cuda()
    rhs = torch.from_numpy(rand64c(2, n ** 3, rng=SEED)).cuda()
    mesh = make_mesh(slice=1, coil=1)
    out = {"transport": C.transport(mesh)}
    if out["transport"] != "nccl":
        raise AssertionError(f"one rank per card runs over NCCL, got "
                             f"{out['transport']}")
    sense_normal_cuda.launches = 0
    x0, _ = sense_batch_recon(Tf, maps, rhs, lamda=lam, iters=ITERS)
    xm, _ = sense_batch_recon(Tf, maps, rhs, mesh=mesh, lamda=lam,
                              iters=ITERS)
    out["k1_launches"] = sense_normal_cuda.launches
    vol = rhs[0].reshape(n, n, n)
    xv, _ = sense_vol_recon(Tf, maps, vol, make_mesh(vol=1), lamda=lam,
                            iters=ITERS)
    xp, _ = sense_vol_recon2(Tf, maps, vol, make_mesh(vz=1, vy=1),
                             lamda=lam, iters=ITERS)
    out["err"] = {"batch": rel_err(xm, x0), "slab": rel_err(xv.ravel(), x0[0]),
                  "pencil": rel_err(xp.ravel(), x0[0])}
    # the NCCL entry of each transport function, on the one-rank group
    g = mesh.group()
    send = rhs[:1].reshape(1, n * n // 8, 8 * n).contiguous()
    got = {"all_to_all_single": C.exchange(send, mesh, g),
           "all_reduce": C.reduce_sum(send, mesh, g),
           "all_gather": C.gather_blocks(send[0], mesh, g)}
    torch.cuda.synchronize()
    for key, val in got.items():
        if not torch.equal(val, send):
            raise AssertionError(f"NCCL {key} on one rank changed its input")
    out["nccl_calls"] = mesh.stats["calls"]
    for key, err in out["err"].items():
        if not err <= PATH_TOL:
            raise AssertionError(f"(e) {key} over NCCL: rel_err {err:.3e}")
    return out


def phase_sharded():
    """Phase 9: the sharded paths on 4 ranks that share the card (gloo), and
    on one rank over NCCL. Returns the K1 launches of all ranks in (a)."""
    import tempfile

    import torch
    from indigo_tpu_torch.models import SenseRecon
    from indigo_tpu_torch.parallel.launch import launch
    from indigo_tpu_torch.parallel.recon import sense_batch_recon
    from indigo_tpu_torch.toeplitz import toeplitz_kernel

    t0 = time.time()
    card = card_line()
    traj = kooshball_traj(NSPOKES, NREAD, seed=SEED)
    maps = coil_maps(N, NC, seed=SEED)
    rec = SenseRecon(traj, maps, oversamp=OVERSAMP, width=WIDTH, iters=ITERS,
                     coil_chunk=COIL_CHUNK, device="cuda")
    y0 = rec.simulate(phantom(N))
    rng = np.random.default_rng(SEED + 8)
    sigma = 0.01 * float(np.sqrt(np.mean(np.abs(y0) ** 2) / 2))
    ys = [(y0 + sigma * (rng.standard_normal(y0.shape, dtype=np.float32)
                         + 1j * rng.standard_normal(y0.shape,
                                                    dtype=np.float32))
           ).astype(np.complex64) for _ in range(2)]
    rhs = torch.cat([rec.rhs(y) for y in ys])                # (2, n)
    x_e2e = rec(ys[0])
    # the raw spectrum the solvers take, with SenseRecon's radial weights
    w = (np.sum(traj ** 2, axis=1) + (0.5 / N) ** 2).astype(np.float32)
    Tf = toeplitz_kernel(traj, (N, N, N), oversamp=OVERSAMP, width=WIDTH,
                         weights=w / w.max(), warn=False, device="cuda")
    lamda = rec.lamda
    x_ref, _ = sense_batch_recon(
        torch.from_numpy(Tf).cuda(), rec.maps, rhs, lamda=lamda,
        iters=ITERS, coil_chunk=COIL_CHUNK)
    with tempfile.TemporaryDirectory(prefix="indigo_sharded_") as work:
        for name, a in (("Tf", Tf), ("maps", maps), ("y", ys[0]),
                        ("rhs", rhs.cpu().numpy()), ("x_e2e", x_e2e),
                        ("x_ref", x_ref.cpu().numpy())):
            np.save(os.path.join(work, name + ".npy"), a)
        del rec, rhs, x_ref, Tf, maps, ys, y0, x_e2e
        torch.cuda.empty_cache()
        log("sharded_inputs", t0, shape=f"{N}^3", nc=NC, rhs=2,
            lamda=f"{lamda:.4g}")
        t0 = time.time()
        out = launch(sharded_ranks, SHARDED_RANKS,
                     args=(work, lamda), timeout=SHARDED_TIMEOUT)
    print(f"[sharded] ranks={SHARDED_RANKS} on one card ({card}); "
          f"transport={out['transport']}: only the collectives' payloads "
          "cross the host, every other operation runs on the card; this "
          "measures correctness and the transport's cost, not scaling",
          flush=True)
    print("[sharded_fft] " + " ".join(
        f"{k}_rel_err={e:.3e} {k}_s={s:.3f}"
        for k, (e, s) in out["fft"].items())
        + f" peak_gb_per_rank={out['peak_gb']['fft']:.2f}", flush=True)
    meshes = {"batch": "slice=2,coil=2", "slab": "vol=4",
              "pencil": "vz=2,vy=2", "e2e": "vol=4"}
    for key, mesh in meshes.items():
        f = out[key]
        print(f"[sharded_{key}] mesh={mesh} " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in f.items())
            + f" peak_gb_per_rank={out['peak_gb'][key]:.2f} "
            f"transport={out['transport']!r} card={card!r}", flush=True)
    log("sharded", t0, ranks=SHARDED_RANKS)
    t0 = time.time()
    one = launch(nccl_one_rank, 1, timeout=300.0)
    log("sharded_nccl", t0, ranks=1, transport=one["transport"], shape="64^3",
        k1_launches=one["k1_launches"], nccl_calls=one["nccl_calls"],
        note="one rank: every mesh axis has size 1, so the entry points skip "
        "their collectives; checked that the paths run and equal the "
        "single-device answer, and that all_to_all_single, all_reduce and "
        "all_gather on the NCCL group return their input",
        **{f"rel_err_{k}": f"{v:.3e}" for k, v in one["err"].items()})
    return int(np.sum(out["batch"]["k1_launches_per_rank"]))


NATIVE_TOL = 1e-5
GATHER_TABLE_ROWS, GATHER_ROWS = 1 << 25, 1 << 24


def phase_native():
    """Phase 10 (a): the native C++ gridding code against the numpy
    build, on the 256^2 radial path's trajectory (grid 384^2) and the
    serving kooshball (grid 320^3)."""
    from indigo_tpu_torch import native
    from indigo_tpu_torch.noncart import interp_mat

    t0 = time.time()
    if not native.available():
        raise AssertionError(f"native gridding library unavailable: {native._error}")
    fields = dict(threads=native.num_threads())
    # the grids of the two paths: oversampling 1.5 (radial), 1.25 (serving)
    cases = (("radial", radial_traj(int(RADIAL_N * 1.5), 2 * RADIAL_N),
              (int(2 * round(RADIAL_N * 1.5 / 2)),) * 2),
             ("kooshball", kooshball_traj(NSPOKES, NREAD, seed=SEED),
              (int(2 * round(N * OVERSAMP / 2)),) * 3))
    for key, traj, grid in cases:
        t = time.time()
        An = interp_mat(traj, grid, width=WIDTH, impl="native")
        tn = time.time() - t
        t = time.time()
        Ap = interp_mat(traj, grid, width=WIDTH, impl="numpy")
        tp = time.time() - t
        err = float(abs(An - Ap).max())
        if An.nnz != Ap.nnz or not err <= NATIVE_TOL:
            raise AssertionError(f"native vs numpy build ({key}): nnz "
                                 f"{An.nnz} / {Ap.nnz}, max |diff| {err:.3e}")
        fields.update({f"{key}_samples": len(traj),
                       f"{key}_grid": "x".join(map(str, grid)),
                       f"{key}_nnz": An.nnz, f"{key}_native_s": f"{tn:.3f}",
                       f"{key}_numpy_s": f"{tp:.3f}",
                       f"{key}_max_abs_diff": f"{err:.3e}"})
        del An, Ap
    log("rest_native", t0, **fields)


def gather_sec_per_row():
    """Seconds per row of a random row gather on the card (the measurement
    behind ``profiling.GATHER_SEC_PER_ROW``): ``index_select`` of
    GATHER_ROWS random rows of 8 bytes from a table of GATHER_TABLE_ROWS,
    timed by differencing chains of 2 and 10 gathers."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(SEED)
    table = torch.randn((GATHER_TABLE_ROWS, 2), device="cuda", generator=g)
    idx = torch.randint(0, GATHER_TABLE_ROWS, (GATHER_ROWS,), device="cuda",
                        generator=g)
    out = torch.empty((GATHER_ROWS, 2), device="cuda")

    def chain(k):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(k):
            torch.index_select(table, 0, idx, out=out)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    chain(2)
    chain(10)
    d = sorted(chain(10) - chain(2) for _ in range(3))[1]
    return d / 8 / GATHER_ROWS


def phase_profiling(roofline, serving_s_per_iter):
    """Phase 10 (b): the card's measured memory rate and row-gather cost,
    phase 7's roofline report, and the CG-iteration floor of the serving
    lane beside phase 3's measured seconds per iteration."""
    import indigo_tpu_torch.profiling as P

    t0 = time.time()
    bw = P.measure_hbm_bandwidth()
    g = gather_sec_per_row()
    nbytes = P.toeplitz_cg_iter_bytes((N,) * 3, NC, layout="kernel",
                                      coil_chunk=COIL_CHUNK)
    macs = P.toeplitz_cg_iter_macs((N,) * 3, NC)
    floor = max(nbytes / P.HBM_BYTES_PER_SEC, macs / P.MXU_MACS_PER_SEC)
    # a copy rate above the published peak would mean the differencing
    # timed the host, not the card
    if not (0 < bw <= 1.1 * P.HBM_BYTES_PER_SEC and g > 0 and nbytes > 0):
        raise AssertionError(f"profiling: bandwidth {bw}, gather {g}, "
                             f"bytes {nbytes}")
    result, text = roofline
    log("rest_profiling", t0, hbm_bytes_per_s_measured=f"{bw:.4g}",
        hbm_bytes_per_s_peak=f"{P.HBM_BYTES_PER_SEC:.4g}",
        hbm_share_of_peak=f"{bw / P.HBM_BYTES_PER_SEC:.4f}",
        gather_sec_per_row_measured=f"{g:.4g}",
        gather_sec_per_row_constant=f"{P.GATHER_SEC_PER_ROW:.4g}",
        cg_iter_bytes_kernel=nbytes, cg_iter_macs=f"{macs:.4g}",
        cg_iter_floor_ms=f"{floor * 1e3:.4f}",
        serving_warm_s_per_iter=f"{serving_s_per_iter:.4f}",
        cg_iter_floor_share=f"{floor / serving_s_per_iter:.4f}",
        cartesian_A_sol_ms=f"{result['sol_sec'] * 1e3:.4f}",
        cartesian_A_measured_ms=f"{result['measured_sec'] * 1e3:.4f}",
        cartesian_A_roofline_frac=f"{result['roofline_frac']:.4f}")
    print("[rest_roofline] " + " | ".join(text.splitlines()), flush=True)


def phase_backends(A_radial):
    """Phase 10 (c): the reference-shaped facade on the card, its csrmm on
    the 256^2 radial path's gridding matrix G (the SpMatrix leaf of
    ``A_radial``, on the card). Returns the K3 launches of its csrmm."""
    import torch
    import indigo_tpu_torch as it
    from indigo_tpu_torch.backends import available_backends, get_backend
    from indigo_tpu_torch.ops.ell_spmm import jag_spmm_cuda
    from indigo_tpu_torch.sparse import jag_to_csr
    from indigo_tpu_torch.utils import rand64c, rel_err

    t0 = time.time()
    b, bn = get_backend("cuda"), get_backend("numpy")
    d = b.Diag(rand64c(64, rng=SEED))
    if not (b.device.type == bn.device.type == "cuda"
            and available_backends() == ["cuda"]):
        raise AssertionError(f"backends: {b}, {bn}, {available_backends()}")
    assert_on_card(d)
    _, _, G = gridding_leaf(A_radial)
    X = torch.from_numpy(rand64c(G.shape[1], RADIAL_NC, rng=SEED)).cuda()
    want = G.apply(X)
    reset_counts()
    got = b.csrmm(G, X)
    torch.cuda.synchronize()
    k3 = jag_spmm_cuda.launches
    if not (torch.equal(got, want) and k3 == 1):
        raise AssertionError(f"csrmm vs SpMatrix: equal "
                             f"{torch.equal(got, want)}, {k3} K3 launches")
    # from the scipy CSR, as a reference script calls it: the facade builds
    # the SpMatrix on the card
    reset_counts()
    csr_err = rel_err(b.csrmm(jag_to_csr(G.ell), X), want)
    k3_csr = jag_spmm_cuda.launches
    if not (csr_err <= SPMM_TOL and k3_csr == 1):
        raise AssertionError(f"csrmm of the CSR: rel_err {csr_err:.3e}, "
                             f"{k3_csr} K3 launches")
    k3 += k3_csr
    vol = (N,) * 3
    v = torch.from_numpy(rand64c(N ** 3, 1, rng=SEED)).cuda()
    f_err = rel_err(b.fftn(v, vol), torch.fft.fftn(v.reshape(vol)).reshape(
        -1, 1))
    i_err = rel_err(b.ifftn(v, vol), (N ** 3) * torch.fft.ifftn(
        v.reshape(vol)).reshape(-1, 1))
    del v
    A, _, x_true = radial_problem(64, 4)
    A = A.to("cuda")
    y = A * torch.from_numpy(x_true)[:, None].cuda()
    rhs = A.H * y
    xb, _ = b.cg(A.H * A, rhs, lamda=RADIAL_LAMDA, tol=0.0, maxiter=30)
    xs, _ = it.cg(A.H * A, rhs, lamda=RADIAL_LAMDA, tol=0.0, maxiter=30)
    cg_err = rel_err(xb, xs)
    for key, err in (("fftn", f_err), ("ifftn", i_err), ("cg", cg_err)):
        if not err <= SPMM_TOL:
            raise AssertionError(f"backends {key}: rel_err {err:.3e}")
    log("rest_backends", t0, backends=f"{b!r},{bn!r}",
        csrmm_shape=f"{G.shape[0]}x{G.shape[1]}xK{RADIAL_NC}",
        csrmm_bitwise_vs_spmatrix=True, csrmm_of_csr_rel_err=f"{csr_err:.3e}",
        csrmm_k3_launches=k3,
        fftn_rel_err=f"{f_err:.3e}", ifftn_rel_err=f"{i_err:.3e}",
        cg_64sq_rel_err_vs_solvers=f"{cg_err:.3e}")
    return k3


def phase_checkpoint(A, x_true):
    """Phase 10 (d): a 256^3 volume round trip, and a 256^2 radial cg
    stopped at 15 iterations, saved, loaded and resumed, against 30
    straight."""
    import tempfile

    import torch
    from indigo_tpu_torch import cg, max_eigen
    from indigo_tpu_torch.checkpoint import load_state, save_state
    from indigo_tpu_torch.utils import rand64c, rel_err

    t0 = time.time()
    v = torch.from_numpy(rand64c(N, N, N, rng=SEED)).cuda()
    with tempfile.TemporaryDirectory(prefix="indigo_ckpt_") as work:
        path = os.path.join(work, "vol.npz")
        torch.cuda.synchronize()
        t = time.time()
        save_state(path, {"x": v, "k": 0})
        t_save = time.time() - t
        t = time.time()
        back = load_state(path, like={"x": v, "k": 0})
        torch.cuda.synchronize()
        t_load = time.time() - t
        mb = os.path.getsize(path) / 1e6
        if not (back["x"].device == v.device and torch.equal(back["x"], v)):
            raise AssertionError("256^3 checkpoint round trip not bitwise")
        del v, back
        # the radial recipe at a well-conditioned lamda (0.3 x the largest
        # eigenvalue of A^H A), where 15 + 15 restarted CG steps converge
        # to the 30-step answer
        y = A * torch.from_numpy(x_true)[:, None].cuda()
        rhs = A.H * y
        AHA = A.H * A
        lam = 0.3 * float(max_eigen(AHA, A.shape[1], iters=20))
        x30, _ = cg(AHA, rhs, lamda=lam, tol=0.0, maxiter=30)
        x15, info = cg(AHA, rhs, lamda=lam, tol=0.0, maxiter=15)
        path = os.path.join(work, "cg.npz")
        save_state(path, {"x": x15, "iters": int(info["iters"])})
        state = load_state(path, like={"x": x15, "iters": 0})
        xr, _ = cg(AHA, rhs, x0=state["x"], lamda=lam, tol=0.0, maxiter=15)
        err = rel_err(xr, x30)
    if not (state["iters"] == 15 and err <= PATH_TOL):
        raise AssertionError(f"checkpointed cg: {state['iters']} iterations "
                             f"saved, resumed vs straight rel_err {err:.3e}")
    log("rest_checkpoint", t0, volume=f"{N}^3", file_mb=f"{mb:.1f}",
        save_s=f"{t_save:.3f}", load_s=f"{t_load:.3f}", bitwise=True,
        cg=f"{RADIAL_N}^2 x {RADIAL_NC} coils, 15 + 15 vs 30",
        lamda=f"{lam:.4g}", rel_err_resumed_vs_straight=f"{err:.3e}")


def phase_examples():
    """Phase 10 (e): the five example scripts at their default sizes on
    the card. Returns the K1 and K3 launches they made."""
    import contextlib
    import io

    import torch
    from indigo_tpu_torch.examples import (
        cartesian_sense_2d, cs_wavelet_fista, multicoil_3d, radial_sense_2d,
        serving_pipeline)
    from indigo_tpu_torch.ops.dft_cuda import sense_normal_cuda
    from indigo_tpu_torch.ops.ell_spmm import jag_spmm_cuda

    # the kernels each example must launch (K1: the Toeplitz CG; K3: the
    # sparse gridding)
    runs = (("cartesian_sense_2d", cartesian_sense_2d, ()),
            ("radial_sense_2d", radial_sense_2d, ("k3",)),
            ("multicoil_3d", multicoil_3d, ("k1",)),
            ("cs_wavelet_fista", cs_wavelet_fista, ()),
            ("serving_pipeline", serving_pipeline, ("k1",)))
    total = {"k1": 0, "k3": 0}
    for name, mod, needs in runs:
        t0 = time.time()
        reset_counts()
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                res = mod.main()        # the card, by its default
            torch.cuda.synchronize()
        except Exception:
            print(printed.getvalue(), flush=True)
            raise
        grew = {"k1": sense_normal_cuda.launches,
                "k3": jag_spmm_cuda.launches}
        if res["device"] != "cuda" or any(grew[k] == 0 for k in needs):
            raise AssertionError(f"example {name}: device {res['device']}, "
                                 f"launches {grew}, expected {needs}")
        for k in total:
            total[k] += grew[k]
        log("rest_example", t0, name=name, k1_launches=grew["k1"],
            k3_launches=grew["k3"], **{
                k: (f"{v:.4g}" if isinstance(v, float) else
                    ",".join(f"{x:.4g}" for x in v) if isinstance(v, list)
                    else v) for k, v in res.items()})
        torch.cuda.empty_cache()
    return total


def phase_rest(roofline, serving_s_per_iter, radial):
    """Phase 10: the rest of the package (native, profiling, backends,
    checkpoint, examples). Returns the K1 and K3 launches it made."""
    t0 = time.time()
    phase_native()
    phase_profiling(roofline, serving_s_per_iter)
    A, x_true = radial
    A = A.to("cuda")
    k3 = phase_backends(A)
    phase_checkpoint(A, x_true)
    del A
    launches = phase_examples()
    launches["k3"] += k3
    log("rest", t0, k1_launches=launches["k1"], k3_launches=launches["k3"])
    return launches


class DeviceSpy:
    """Counts the calls of ``module.name`` by the device of their tensor
    arguments ("none" for calls with no tensor), while in a ``with``."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, {}

    def __enter__(self):
        import torch
        self.fn = getattr(self.module, self.name)

        def spy(*args, **kw):
            devs = {a.device.type for a in args if torch.is_tensor(a)}
            key = ",".join(sorted(devs)) or "none"
            self.calls[key] = self.calls.get(key, 0) + 1
            return self.fn(*args, **kw)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def phase_boundary():
    """Phase 11: the 3D Toeplitz recipe from 64-bit numpy with no device=,
    the radial lane's bare SpMatrix and set_spmm_impl, sense_batch_recon
    from numpy, and the reference's call forms (boundary_call_forms).
    Returns the K1, K2, K3 and K4 launches."""
    import torch
    from indigo_tpu_torch import SpMatrix, cg, noncart, sense_normal_toeplitz
    from indigo_tpu_torch.models.sense import sense_nufft_op
    from indigo_tpu_torch.noncart import pipe_menon_dcf
    from indigo_tpu_torch.ops import set_spmm_impl, spmm, tile_interp
    from indigo_tpu_torch.ops.dft_cuda import (
        LAUNCHES_PER_CALL, sense_normal_cuda, toeplitz_apply_cuda,
        toeplitz_apply_reference)
    from indigo_tpu_torch.ops.ell_spmm import jag_spmm_cuda
    from indigo_tpu_torch.parallel import sense_batch_recon
    from indigo_tpu_torch.sparse import jag_to_csr
    from indigo_tpu_torch.toeplitz import toeplitz_kernel
    from indigo_tpu_torch.utils import rel_err

    t_phase = time.time()
    traj = kooshball_traj(NSPOKES, NREAD, seed=SEED)        # float64
    maps = coil_maps(N, NC, seed=SEED).astype(np.complex128)
    x_true = phantom(N).astype(np.complex128).ravel()
    grid = tuple(int(2 * round(s * OVERSAMP / 2)) for s in (N,) * 3)
    fields = {"shape": f"{N}^3", "nc": NC, "card": repr(card_line())}

    def host_free(key, t0, scatter, host):
        torch.cuda.synchronize()
        fields[f"{key}_s"] = f"{time.time() - t0:.3f}"
        if set(scatter.calls) != {"cuda"} or host.calls:
            raise AssertionError(f"{key} left its device path: gathers "
                                 f"{scatter.calls}, host matrix {host.calls}")

    reset_counts()
    with DeviceSpy(tile_interp, "kb_scatter") as sc, \
            DeviceSpy(noncart, "interp_mat") as host:
        t0 = time.time()
        w = pipe_menon_dcf(traj, grid, width=WIDTH, iters=DCF_ITERS)
        host_free("dcf", t0, sc, host)
    with DeviceSpy(tile_interp, "kb_scatter") as sc, \
            DeviceSpy(noncart, "interp_mat") as host:
        t0 = time.time()
        Tf, info = toeplitz_kernel(traj, (N,) * 3, oversamp=OVERSAMP,
                                   width=WIDTH, weights=w, return_info=True,
                                   warn=False)
        host_free("spectrum", t0, sc, host)
    t0 = time.time()
    Nop = sense_normal_toeplitz(Tf, maps)
    bad = [(t.device.type, t.dtype) for t in Nop.buffers()
           if not (t.is_cuda and t.dtype in (torch.complex64,
                                             torch.float32))]
    if bad:
        raise AssertionError(f"sense_normal_toeplitz from complex128 numpy: "
                             f"buffers {bad[:3]}")
    A, plan = sense_nufft_op(traj, maps, oversamp=OVERSAMP, width=WIDTH)
    y = A * x_true
    wd = np.tile(w[plan.perm], NC)                        # float32 numpy
    # the rhs as a user holds it on the host: numpy's complex128
    b = (A.H * (wd * y.cpu().numpy())).cpu().numpy().astype(np.complex128)
    del A, y
    torch.cuda.synchronize()
    fields["operator_s"] = f"{time.time() - t0:.3f}"
    lam = max(1e-3, 10.0 ** (1 - WIDTH)) * info["max"]
    solve_s, k2 = [], []
    for _ in range(2):
        before = toeplitz_apply_cuda.launches
        t0 = time.time()
        x, cinfo = cg(Nop, b, lamda=lam, tol=0.0, maxiter=ITERS,
                      history=True)
        res = cinfo["resids"].cpu().numpy()
        solve_s.append(time.time() - t0)
        k2.append(toeplitz_apply_cuda.launches - before)
    if not (x.is_cuda and x.dtype == torch.complex64):
        raise AssertionError(f"cg from complex128 numpy: {x.device} "
                             f"{x.dtype}")
    if k2 != [LAUNCHES_PER_CALL * (ITERS + 1)] * 2 or \
            toeplitz_apply_reference.cuda_calls:
        raise AssertionError(f"cg from numpy: K2 launches {k2}, plain "
                             f"applies {toeplitz_apply_reference.cuda_calls}")
    if not (np.all(np.isfinite(res)) and res[-1] < res[0]):
        raise AssertionError(f"cg from numpy: residuals {res}")
    Nc = sense_normal_toeplitz(torch.from_numpy(Tf).to("cuda"),
                               torch.from_numpy(maps.astype(np.complex64)
                                                ).to("cuda"), device="cuda")
    # the numpy b's narrowing and copy, which each solve from numpy pays
    t0 = time.time()
    bc = torch.from_numpy(b.astype(np.complex64)).to("cuda")
    torch.cuda.synchronize()
    b_to_card_s = time.time() - t0
    t0 = time.time()
    xc, _ = cg(Nc, bc, lamda=lam, tol=0.0, maxiter=ITERS)
    torch.cuda.synchronize()
    tensor_solve_s = time.time() - t0
    err_solve = rel_err(x, xc)
    del Nc, xc, bc
    if not err_solve <= PATH_TOL:
        raise AssertionError(f"cg from complex128 numpy vs complex64 "
                             f"tensors: rel_err {err_solve:.3e}")
    fields.update(first_s=f"{solve_s[0]:.3f}", warm_s=f"{solve_s[1]:.3f}",
                  b_to_card_s=f"{b_to_card_s:.3f}",
                  complex64_tensor_solve_s=f"{tensor_solve_s:.3f}",
                  k2_launches=sum(k2), resid_last=f"{res[-1]:.4e}",
                  rel_err_vs_complex64_tensors=f"{err_solve:.3e}")

    # K1: the batch solver from numpy, against the tree's solve
    t0 = time.time()
    before = sense_normal_cuda.launches
    xs, _ = sense_batch_recon(Tf, maps, b.reshape(1, -1), lamda=lam,
                              iters=ITERS)
    torch.cuda.synchronize()
    k1 = sense_normal_cuda.launches - before
    err_k1 = rel_err(xs[0], x[:, 0] if x.dim() == 2 else x)
    if k1 != LAUNCHES_PER_CALL * ITERS or not xs.is_cuda or \
            not err_k1 <= PATH_TOL:
        raise AssertionError(f"sense_batch_recon from numpy: K1 launches "
                             f"{k1}, {xs.device}, vs the tree {err_k1:.3e}")
    fields.update(batch_s=f"{time.time() - t0:.3f}", k1_launches=k1,
                  rel_err_batch_vs_tree=f"{err_k1:.3e}")
    del Nop, xs, x
    torch.cuda.empty_cache()

    # K3: a bare SpMatrix of the radial lane's gridding matrix (its sorted
    # samples and tiled columns) as a float64 scipy CSR
    t0 = time.time()
    _, _, leaf = gridding_leaf(radial_problem(RADIAL_N, RADIAL_NC)[0])
    G64 = jag_to_csr(leaf.ell).astype(np.float64)
    del leaf
    G = SpMatrix(G64)
    rng = np.random.default_rng(SEED)
    xg = (rng.standard_normal((G.shape[1], 2))
          + 1j * rng.standard_normal((G.shape[1], 2)))      # complex128
    before = jag_spmm_cuda.launches
    yk = G * xg
    k3_kernel = jag_spmm_cuda.launches - before
    plain = spmm.plain_cuda_calls
    try:
        set_spmm_impl("jnp")
        before = jag_spmm_cuda.launches
        yp = G * xg
        k3_jnp = jag_spmm_cuda.launches - before
    finally:
        set_spmm_impl("auto")
    plain = spmm.plain_cuda_calls - plain
    before = jag_spmm_cuda.launches
    ya = G * xg
    torch.cuda.synchronize()
    k3_auto = jag_spmm_cuda.launches - before
    err_jnp = rel_err(yp, yk)
    if not (yk.is_cuda and yk.dtype == torch.complex64 and k3_kernel == 1
            and k3_jnp == 0 and plain == 1 and k3_auto == 1
            and err_jnp <= SPMM_TOL and torch.equal(ya, yk)):
        raise AssertionError(
            f"bare SpMatrix: {yk.device} {yk.dtype}, K3 launches kernel "
            f"{k3_kernel} jnp {k3_jnp} auto {k3_auto}, plain calls {plain}, "
            f"jnp vs kernel {err_jnp:.3e}")
    fields.update(spmatrix=f"{G.shape[0]}x{G.shape[1]}",
                  spmatrix_dtype=str(G.dtype).replace("torch.", ""),
                  k3_launches=k3_kernel + k3_auto,
                  rel_err_jnp_vs_kernel=f"{err_jnp:.3e}",
                  spmatrix_s=f"{time.time() - t0:.3f}")
    del G, yk, yp, ya
    torch.cuda.empty_cache()
    k34 = boundary_call_forms(traj, grid, G64)
    log("boundary", t_phase, **fields)
    return {"k1": k1, "k2": sum(k2), "k3": k3_kernel + k3_auto + k34["k3"],
            "k4": k34["k4"]}


def group_major_order(plan):
    """The reference's grouped-forward sample order, from a plan built
    without it: samples sorted (stably) by how many super-tile members
    their patch covers along each axis (KB weights are > 0 on the whole
    patch, so a member is covered where its weights are not all zero)."""
    code = np.zeros(plan.n_samples, dtype=np.int64)
    for w in plan.wfac:
        code = code * w.shape[1] + ((w > 0).any(axis=2).sum(axis=1) - 1)
    return np.argsort(code, kind="stable")


def boundary_call_forms(traj, grid, G64):
    """Phase 11, the reference's call forms at full width: (a) K3 and K4
    from csr_to_jag / csr_to_bell(G_f64, dtype=np.float64); (b) the
    serving plan from every (adjoint, forward, reorder) of the reference's
    plan_tile_interp; (c) centered_fft_op(dtype=np.complex128). Returns
    the K3 and K4 launches of (a)'s applies."""
    import torch
    from indigo_tpu_torch.models import centered_fft_op
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.ops.tile_interp import plan_tile_interp
    from indigo_tpu_torch.sparse import csr_to_bell, csr_to_jag

    card = repr(card_line())
    # (a) the radial lane's coil batch, complex64 on the card
    t0 = time.time()
    rng = np.random.default_rng(SEED + 11)
    xs = torch.from_numpy((rng.standard_normal((G64.shape[1], RADIAL_NC))
                           + 1j * rng.standard_normal(
                               (G64.shape[1], RADIAL_NC))
                           ).astype(np.complex64)).to("cuda")
    launches, fields = {}, {}
    for key, conv, kern in (("k3", csr_to_jag, jag_spmm_cuda),
                            ("k4", csr_to_bell, ell_spmm_cuda)):
        mat64 = conv(G64, dtype=np.float64).to("cuda")
        k0, plain = kern.launches, spmm.plain_cuda_calls
        y64 = spmm(mat64, xs)
        torch.cuda.synchronize()
        launches[key] = kern.launches - k0
        plain = spmm.plain_cuda_calls - plain
        same = torch.equal(y64, spmm(conv(G64).to("cuda"), xs))
        if not (mat64.nz_val.dtype == torch.float32 and launches[key] == 1
                and plain == 0 and same):
            raise AssertionError(
                f"{conv.__name__}(G_f64, dtype=np.float64): nz_val "
                f"{mat64.nz_val.dtype}, {kern.__name__} launches "
                f"{launches[key]}, plain calls {plain}, bitwise {same}")
        fields[f"{kern.__name__}_ms"] = \
            f"{queued_ms(lambda: spmm(mat64, xs), 50):.4f}"
        del mat64, y64
    log("boundary_f64_conversions", t0, card=card,
        matrix=f"{G64.shape[0]}x{G64.shape[1]}", nnz=G64.nnz,
        x=f"{tuple(xs.shape)} complex64", k3_launches=launches["k3"],
        k4_launches=launches["k4"], plain_calls=0,
        bitwise_vs_default=True, **fields)
    del xs

    # (b) the serving plan from the reference's keywords
    t0 = time.time()
    plans, build_s = {}, {}
    for reorder in (False, True):
        for forward in ("grouped", "dense"):
            for adjoint in ("binned", "scatter"):
                t = time.time()
                plans[adjoint, forward, reorder] = plan_tile_interp(
                    traj, grid, width=WIDTH, adjoint=adjoint,
                    forward=forward, reorder=reorder)
                build_s[adjoint, forward, reorder] = time.time() - t
    base = plans["binned", "grouped", False]
    order = group_major_order(base)
    if np.array_equal(order, np.arange(base.n_samples)):
        raise AssertionError("the serving kooshball is already group-major")

    def same(p, perm=None):
        idx = slice(None) if perm is None else perm
        return (np.array_equal(p.tid, base.tid[idx])
                and all(np.array_equal(w, wb[idx])
                        for w, wb in zip(p.wfac, base.wfac, strict=True)))

    for (adjoint, forward, reorder), p in plans.items():
        want = order if reorder and forward == "grouped" else None
        got = p.sample_perm
        if not ((want is None and got is None) or (
                want is not None and got is not None
                and np.array_equal(got, want))) or not same(p, want):
            raise AssertionError(
                f"plan_tile_interp(adjoint={adjoint!r}, forward={forward!r}, "
                f"reorder={reorder}) breaks the reference's rule: "
                f"sample_perm {None if got is None else got[:4]}")
    log("boundary_plan_keywords", t0, card=card, grid=f"{grid}",
        samples=base.n_samples, S=base.S,
        memusage_gb=f"{base.memusage() / 1e9:.3f}", plans=len(plans),
        build_s=",".join(f"{a}/{f}/{int(r)}:{v:.3f}"
                         for (a, f, r), v in build_s.items()),
        equal_without_reorder=True, grouped_reorder_is_group_major=True,
        dense_reorder_is_identity=True)
    del plans, base

    # (c) the centered FFT with a 64-bit dtype, on the tree lane's image
    t0 = time.time()
    F64 = centered_fft_op((N,) * 3, dtype=np.complex128)
    F32 = centered_fft_op((N,) * 3, dtype=np.complex64)
    assert_on_card(F64)
    img = torch.from_numpy(phantom(N).reshape(-1, 1)).to("cuda")
    y = F64 * img
    same = y.dtype == torch.complex64 and torch.equal(y, F32 * img)
    if not same:
        raise AssertionError(f"centered_fft_op(dtype=np.complex128): "
                             f"{y.dtype}, bitwise the complex64 op's: {same}")
    log("boundary_centered_fft", t0, card=card, shape=f"{N}^3",
        dtype=str(F64.dtype).replace("torch.", ""), bitwise_vs_complex64=True,
        ms_per_apply=f"{timed(lambda: F64 * img, 10):.3f}")
    del F64, F32, img, y
    torch.cuda.empty_cache()
    return launches


# ---- phase 12: gradients through the kernels -------------------------------

GRAD_TOL = {"K1": 1e-4, "K2": 1e-4, "K3": 1e-5, "K4": 1e-5}
SILENT_TOL = 1e-5
# the central difference's steps (relative to |y|), and the bar on the
# smallest of its errors against the gradient, on a noisy acquisition and
# on the noise-free y0. The loss is quadratic in x, so only CG's
# nonlinearity in y errs at large steps; f32 rounding of x errs at small
# ones. The H100 read smallest errors of 3.5e-4 to 3.9e-4 (noisy, step
# 1e-2) and 9.4e-3 (noise-free, step 3e-3; 1.15e-2 at 1e-2, 3.7e-2 at 1e-3)
FD_STEPS = (3e-2, 1e-2, 3e-3, 1e-3, 3e-4, 1e-4)
FD_TOL = {"noisy": 2e-3, "noise_free": 2e-2}
# phase 12d: interleaved pairs of warm radial solves, through _SpmmFn and bare
FN_COST_PAIRS = 10


def kernel_launches():
    from indigo_tpu_torch.ops.dft_cuda import (
        sense_normal_cuda, toeplitz_apply_cuda)
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    return dict(k1=sense_normal_cuda.launches, k2=toeplitz_apply_cuda.launches,
                k3=jag_spmm_cuda.launches, k4=ell_spmm_cuda.launches)


def plain_calls_on_card():
    """Calls of the plain versions on CUDA tensors since reset_counts()."""
    from indigo_tpu_torch.ops import spmm
    from indigo_tpu_torch.ops.dft_cuda import (
        sense_normal_reference, toeplitz_apply_reference)
    return (sense_normal_reference.cuda_calls
            + toeplitz_apply_reference.cuda_calls + spmm.plain_cuda_calls)


def sq_norm(z):
    """sum |z|^2 of a complex tensor, in float64, differentiable."""
    import torch
    return torch.view_as_real(z).double().pow(2).sum()


def grad_of(f, x, g):
    """Autograd's gradient of f at x on the cotangent g."""
    v = x.clone().requires_grad_()
    f(v).backward(g)
    return v.grad


def grad_check(name, kern, per_call, fwd, adj, x, g, timer, label,
               **fields):
    """Phase 12a, one kernel in one direction: autograd's gradient of fwd at
    x on the cotangent g is bitwise adj(g), the explicit adjoint call; the
    forward and the backward each make one kernel call (``per_call``
    launches) and no plain call. Prints the forward ms (through the
    Function) beside the backward ms (``timer``). Returns the launches of
    the forward and backward."""
    import torch

    t0 = time.time()
    torch.cuda.synchronize()
    reset_counts()
    v = x.clone().requires_grad_()
    out = fwd(v)
    k_fwd = kern.launches
    out.backward(g)
    torch.cuda.synchronize()
    launches, plain = kern.launches, plain_calls_on_card()
    if (k_fwd, launches - k_fwd, plain) != (per_call, per_call, 0):
        raise AssertionError(f"{name} gradient at {label}: {k_fwd} forward "
                             f"and {launches - k_fwd} backward launches, "
                             f"{plain} plain calls")
    if v.grad.dtype != x.dtype or not torch.equal(v.grad, adj(g)):
        raise AssertionError(f"{name} gradient at {label} is not bitwise "
                             "the explicit adjoint call")
    fwd_ms = timer(lambda: fwd(v))
    out = fwd(v)

    def backward():
        v.grad = None
        out.backward(g, retain_graph=True)
    bwd_ms = timer(backward)
    log("grad_kernel", t0, kernel=name, at=label, launches_fwd=k_fwd,
        launches_bwd=launches - k_fwd, plain_calls=plain,
        bitwise_vs_adjoint_call=True, **fields, fwd_ms=f"{fwd_ms:.4f}",
        bwd_ms=f"{bwd_ms:.4f}", card=repr(card_line()))
    return launches


def grad_toeplitz_kernels():
    """Phase 12a for K1 (256^3, nc 4) and K2 (256^3, B 8) on a random
    spectrum, maps, operand and cotangent made on the card from the seed.
    The plain version's autograd is compared at 256^3 where the card holds
    its saved doubled-grid stages, else at 128^3 (the line says which).
    Returns the launches by kernel."""
    import torch
    from indigo_tpu_torch.ops.dft_cuda import (
        LAUNCHES_PER_CALL, sense_normal_cuda, sense_normal_reference,
        toeplitz_apply_cuda, toeplitz_apply_reference)
    from indigo_tpu_torch.utils import rel_err

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def inputs(n, B, nc):
        c = dict(generator=gen, device="cuda", dtype=torch.complex64)
        T = torch.rand((2 * n,) * 3, generator=gen, device="cuda")
        ops = (T,) if nc is None else (T, torch.randn((nc,) + (n,) * 3, **c))
        return ops, torch.randn((B,) + (n,) * 3, **c), \
            torch.randn((B,) + (n,) * 3, **c)

    out = {}
    for key, kern, plain, B, nc in (
            ("K1", sense_normal_cuda, sense_normal_reference, 1, 4),
            ("K2", toeplitz_apply_cuda, toeplitz_apply_reference, 8, None)):
        err = None
        for n in (N, 128):
            ops, x, g = inputs(n, B, nc)
            try:
                err = rel_err(grad_of(partial(kern, *ops), x, g),
                              grad_of(partial(plain, *ops), x, g))
            except torch.cuda.OutOfMemoryError:
                pass
            if err is not None:
                break
            del ops, x, g
            torch.cuda.empty_cache()
        if err is None or not err <= GRAD_TOL[key]:
            raise AssertionError(f"{key} gradient vs the plain version's "
                                 f"autograd at {n}^3: rel_err {err:.3e}")
        if n != N:
            ops, x, g = inputs(N, B, nc)
        f = partial(kern, *ops)
        out[key.lower()] = grad_check(
            key, kern, LAUNCHES_PER_CALL, f, f, x, g, partial(timed, reps=5),
            f"{N}^3 " + (f"B {B}" if nc is None else f"nc {nc}"),
            rel_err_vs_plain_autograd=f"{err:.3e}",
            plain_autograd_at=f"{n}^3")
        del ops, x, g, f
        torch.cuda.empty_cache()
    return out


def grad_spmm(ops):
    """Phase 12a for K3 (the radial lane's G, jag, at 256^2) and K4 (G as
    blocked-ELL at 128^2), each forward and adjoint through SpMatrix, on
    complex operands of the lane's 8 coil columns; the plain version's
    autograd on the card within 1e-5. Returns the launches by kernel."""
    import torch
    from indigo_tpu_torch.operators import SpMatrix
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    from indigo_tpu_torch.sparse import bell_spmm, jag_spmm, jag_to_csr
    from indigo_tpu_torch.utils import rel_err

    _, _, G = gridding_leaf(ops[RADIAL_N])
    _, _, G128 = gridding_leaf(ops[128])
    Gb = SpMatrix(jag_to_csr(G128.ell), format="bell", device="cuda")
    rng = np.random.default_rng(SEED + 12)
    out = {"k3": 0, "k4": 0}
    for key, op, n, kern, plain in (
            ("K3", G, RADIAL_N, jag_spmm_cuda, jag_spmm),
            ("K4", Gb, 128, ell_spmm_cuda, bell_spmm)):
        for adjoint in (False, True):
            rows, cols = op.shape[::-1] if adjoint else op.shape
            x, g = (torch.from_numpy(
                (rng.standard_normal((m, 2 * RADIAL_NC), dtype=np.float32)
                 .view(np.complex64))).to("cuda") for m in (cols, rows))
            fwd = partial(op.apply, adjoint=adjoint)
            E = op.ellH if adjoint else op.ell
            err = rel_err(grad_of(fwd, x, g), grad_of(partial(plain, E), x, g))
            label = f"{'G^H' if adjoint else 'G'} {n}^2"
            if not err <= GRAD_TOL[key]:
                raise AssertionError(f"{key} gradient at {label} vs the "
                                     f"plain version's autograd: {err:.3e}")
            out[key.lower()] += grad_check(
                key, kern, 1, fwd, partial(op.apply, adjoint=not adjoint),
                x, g, partial(queued_ms, reps=50), label,
                rel_err_vs_plain_autograd=f"{err:.3e}")
    del Gb
    return out


def silent_case(path, N_op, x, b, lam):
    """Phase 12b: autograd's gradient in x of L = ||(N + lam I) x - b||^2
    against 2 (N + lam I) r, r = (N + lam I) x - b, from explicit applies
    (N is Hermitian). The kernels' output is summed with lam x, which
    carries the graph whatever N does: where the kernels cut the graph the
    gradient comes back finite and wrong. Prints the reading and returns
    (rel_err, the graded run's launches); holds it to no bar."""
    import torch
    from indigo_tpu_torch.utils import rel_err

    t0 = time.time()
    torch.cuda.synchronize()
    reset_counts()
    xg = x.clone().requires_grad_()
    sq_norm(N_op * xg + lam * xg - b).backward()
    torch.cuda.synchronize()
    launches, plain = kernel_launches(), plain_calls_on_card()
    with torch.no_grad():
        r = N_op * x + lam * x - b
        ref = 2 * (N_op * r + lam * r)
    err = rel_err(xg.grad, ref)
    log("grad_silent", t0, path=path, rel_err=f"{err:.3e}",
        grad_finite=bool(torch.isfinite(xg.grad).all()),
        **{f"{k}_launches": v for k, v in launches.items() if v},
        plain_calls=plain, card=repr(card_line()))
    return err, launches


def radial_silent_case(ops):
    """The silent case on the 2D radial lane: N = A.H * A at 256^2 / 8
    coils (K3), b = A^H y of the noisy data, the recipe's lamda."""
    import torch
    A = ops[RADIAL_N]
    x_true = torch.from_numpy(ops["x_true"][RADIAL_N])[:, None].to("cuda")
    b = A.H * add_noise(A * x_true, SEED + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    x = torch.randn(b.shape, generator=gen, device="cuda",
                    dtype=torch.complex64)
    return silent_case(f"radial {RADIAL_N}^2", A.H * A, x, b, RADIAL_LAMDA)


def tree_silent_case(st):
    """The silent case on the 3D tree: N = sense_normal_toeplitz at 256^3 /
    8 coils (K2), b its recipe's rhs, its lamda."""
    import torch
    b = st["rhs"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    x = torch.randn(b.shape, generator=gen, device="cuda",
                    dtype=torch.complex64)
    return silent_case(f"tree {N}^3", st["N"], x, b, st["lamda"])


def held_silent(reading, kernel, launches):
    """Hold a silent-case reading: within SILENT_TOL, with ``launches`` of
    ``kernel`` forward and backward together. Returns those launches."""
    err, got = reading
    if not err <= SILENT_TOL or got[kernel] != launches:
        raise AssertionError(f"silent case: rel_err {err:.3e}, launches "
                             f"{got}")
    return launches


def fd_scan(loss, y, grad, d):
    """Re<grad, d> and the central difference's relative error against it
    at each step of FD_STEPS."""
    import torch
    an = float((grad.conj() * d).real.double().sum())
    with torch.no_grad():
        fds = {eps: float(loss(y + eps * d) - loss(y - eps * d)) / (2 * eps)
               for eps in FD_STEPS}
    return an, {eps: abs(fd - an) / abs(an) for eps, fd in fds.items()}


def grad_recon(serving):
    """Phase 12c: the main path differentiated. L = ||x - x_true||^2 of
    x = recon(y, output="device") at the serving lane's size, y a k-space
    tensor that requires grad (phase 3's second noisy acquisition);
    backward. Checks: the gradient is finite; K1 runs ITERS x chunks calls
    forward and as many backward; no plain call. Then the gradient at the
    noise-free y0 too, and at both a central difference along one seeded
    direction d (the k-space of a smooth random image) at every step of
    FD_STEPS against Re<grad, d>; the smallest error of each is held to
    its FD_TOL.
    Prints the warm forward s (no graph), the forward with its graph and
    the backward, first and again warm, and the peak GB, then profiles one
    forward with its graph and its backward. Returns the K1 launches of the
    checked run."""
    import torch
    from indigo_tpu_torch.ops.dft_cuda import (
        LAUNCHES_PER_CALL, sense_normal_cuda)

    recon, x_true = serving["recon"], serving["x_true"]
    t0 = time.time()
    yt = torch.from_numpy(serving["y"]).to("cuda")
    xt = torch.from_numpy(np.ascontiguousarray(x_true.ravel())).to("cuda")

    def loss(yy):
        return sq_norm(recon(yy, output="device").reshape(-1) - xt)

    def clock(f):
        torch.cuda.synchronize()
        t = time.time()
        out = f()
        torch.cuda.synchronize()
        return out, time.time() - t

    with torch.no_grad():
        loss(yt)
        _, warm_s = clock(lambda: loss(yt))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    yg = yt.clone().requires_grad_()
    L, fwd_s = clock(lambda: loss(yg))
    k_fwd = sense_normal_cuda.launches
    _, bwd_s = clock(L.backward)
    k_bwd = sense_normal_cuda.launches - k_fwd
    peak = torch.cuda.max_memory_allocated() / 1e9
    calls = ITERS * (NC // COIL_CHUNK)
    if (k_fwd, k_bwd) != (LAUNCHES_PER_CALL * calls,) * 2:
        raise AssertionError(f"recon gradient: {k_fwd} forward and {k_bwd} "
                             f"backward K1 launches, expected "
                             f"{LAUNCHES_PER_CALL * calls} each")
    if plain_calls_on_card() or not bool(torch.isfinite(yg.grad).all()):
        raise AssertionError("recon gradient: a plain call ran on the card "
                             "or the gradient is not finite")
    log("grad_recon", t0, shape=f"{N}^3", nc=NC, iters=ITERS,
        coil_chunk=COIL_CHUNK, k1_calls_fwd=k_fwd // LAUNCHES_PER_CALL,
        k1_calls_bwd=k_bwd // LAUNCHES_PER_CALL, plain_calls=0,
        grad_finite=True, loss=f"{L.item():.6e}",
        warm_fwd_s=f"{warm_s:.4f}", first_fwd_with_graph_s=f"{fwd_s:.4f}",
        first_bwd_s=f"{bwd_s:.4f}", peak_gb=f"{peak:.2f}",
        card=repr(card_line()))
    grad = yg.grad
    del L, yg
    # the direction: the k-space of a smooth random image (white k-space
    # noise would move x mostly through CG's ill-conditioned, nonlinear
    # part, where no step resolves the first-order term in f32)
    d = torch.from_numpy(recon.simulate(coil_maps(N, 1, seed=SEED + 12)[0]))
    d = d.to("cuda") * (torch.linalg.vector_norm(yt)
                        / torch.linalg.vector_norm(d))
    y0 = torch.from_numpy(serving["y0"]).to("cuda")
    y0g = y0.clone().requires_grad_()
    loss(y0g).backward()
    for kind, y, g in (("noisy", yt, grad), ("noise_free", y0, y0g.grad)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"recon gradient at the {kind} y is not "
                                 "finite")
        an, errs = fd_scan(loss, y, g, d)
        step = min(errs, key=errs.get)
        log("grad_recon_fd", t0, y=kind, loss=f"{float(loss(y)):.6e}",
            re_grad_dot_d=f"{an:.6e}", step_held=step,
            rel_err_fd=f"{errs[step]:.3e}", fd_tol=FD_TOL[kind],
            rel_err_fd_by_step=",".join(f"{e:g}:{v:.3e}"
                                        for e, v in errs.items()),
            card=repr(card_line()))
        if not errs[step] <= FD_TOL[kind]:
            raise AssertionError(f"recon gradient at the {kind} y vs central "
                                 f"difference: rel {errs[step]:.3e} at the "
                                 "best step")
    del grad, y0g
    yg = yt.clone().requires_grad_()
    L, fwd_warm_s = clock(lambda: loss(yg))
    _, bwd_warm_s = clock(L.backward)
    log("grad_recon_warm", t0, fwd_with_graph_s=f"{fwd_warm_s:.4f}",
        bwd_s=f"{bwd_warm_s:.4f}", card=repr(card_line()))
    del L, yg
    yg = yt.clone().requires_grad_()
    profile_solve("serving_gradient", lambda: loss(yg).backward())
    return {"k1": k_fwd + k_bwd}


def function_cost(ops):
    """Phase 12d: what launching K3 through _SpmmFn would cost the
    host-bound radial solve (30 CG iterations, 62 K3 launches, no grad):
    warm solves as shipped (the bare launch, as nothing requires grad) and
    with every launch forced through the Function, FN_COST_PAIRS pairs in
    alternating order. Prints the medians and their difference per solve
    and per launch."""
    import torch
    from indigo_tpu_torch.ops import ell_spmm

    t0 = time.time()
    A = ops[RADIAL_N]
    x_true = torch.from_numpy(ops["x_true"][RADIAL_N])[:, None].to("cuda")
    b = A.H * add_noise(A * x_true, SEED + 1)
    gates = {"direct": ell_spmm._carries_graph, "function": lambda x: True}
    secs = {k: [] for k in gates}
    for i in range(2 * FN_COST_PAIRS + 1):
        order = ("function", "direct") if i % 2 else ("direct", "function")
        for route in order:
            ell_spmm._carries_graph = gates[route]
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                radial_solve(A, b)
                torch.cuda.synchronize()
                if i:  # the first round warms both routes
                    secs[route].append(time.perf_counter() - t)
            finally:
                ell_spmm._carries_graph = gates["direct"]
    med = {k: float(np.median(v)) for k, v in secs.items()}
    launches = 2 + 2 * RADIAL_ITERS
    diff = med["function"] - med["direct"]
    log("grad_fn_cost", t0, path=f"radial {RADIAL_N}^2",
        solves=len(secs["direct"]), k3_launches_per_solve=launches,
        direct_median_s=f"{med['direct']:.5f}",
        function_median_s=f"{med['function']:.5f}",
        direct_range_s=f"{min(secs['direct']):.5f}-"
        f"{max(secs['direct']):.5f}",
        function_range_s=f"{min(secs['function']):.5f}-"
        f"{max(secs['function']):.5f}",
        diff_s=f"{diff:.6f}", diff_us_per_launch=f"{diff / launches * 1e6:.2f}",
        card=repr(card_line()))


def grad_radial(ops):
    """Phase 12a (K3, K4), 12b and 12d on the radial lane. Returns the K3
    and K4 launches."""
    out = grad_spmm(ops)
    out["k3"] += held_silent(radial_silent_case(ops), "k3", 4)
    function_cost(ops)
    return out


def grad_tree(st):
    """Phase 12b on the 3D tree. Returns the K2 launches."""
    from indigo_tpu_torch.ops.dft_cuda import LAUNCHES_PER_CALL
    return {"k2": held_silent(tree_silent_case(st), "k2",
                              2 * LAUNCHES_PER_CALL)}


# phase 12, lane by lane: each part runs on the objects of its lane's phase
# (3, 5, 6b) and returns its launches by kernel; the kernels' part last
GRAD_PARTS = {"serving": grad_recon, "radial": grad_radial,
              "tree": grad_tree, "kernels": lambda _: grad_toeplitz_kernels()}


def grad_part(lane, obj, grads):
    """Run phase 12's part for ``lane`` on ``obj``; add its launches to
    ``grads``."""
    for k, v in GRAD_PARTS[lane](obj).items():
        grads[k] += v


def serving_lane():
    recon = serving_recon(kooshball_traj(NSPOKES, NREAD, seed=SEED),
                          coil_maps(N, NC, seed=SEED))
    x_true = phantom(N)
    y0, ys = serving_data(recon, x_true)
    return dict(recon=recon, y0=y0, y=ys[1], x_true=x_true)


def tree_lane():
    return tree_recipe(kooshball_traj(NSPOKES, NREAD, seed=SEED),
                       coil_maps(N, NC, seed=SEED), phantom(N), "cuda")


def phase_gradients():
    """Phase 12 alone: builds each lane with the builders of phases 3, 5
    and 6b and runs its part, in main()'s order. Returns the launches by
    kernel."""
    import torch
    grads = dict(k1=0, k2=0, k3=0, k4=0)
    for lane, build in (("serving", serving_lane),
                        ("radial", build_radial_ops), ("tree", tree_lane),
                        ("kernels", lambda: None)):
        obj = build()
        grad_part(lane, obj, grads)
        del obj
        torch.cuda.empty_cache()
    return grads


def f9_reading():
    """Phase 12b's two readings alone, held to no bar: on a tree whose
    kernels cut the autograd graph they show the fault."""
    import torch
    ops = build_radial_ops()
    radial_silent_case(ops)
    del ops
    torch.cuda.empty_cache()
    tree_silent_case(tree_lane())


def main():
    phase_device()
    phase_build()
    import torch
    worst, timing = phase_kernels()
    pad_worst, pad_timing, pad_launches = phase_pad_dft()
    launches, main_pad, serving_s_per_iter, serving = phase_main_path()
    pad_launches += main_pad
    # phase 12 runs on each lane's objects while they exist
    grads = dict(k1=0, k2=0, k3=0, k4=0)
    grad_part("serving", serving, grads)
    del serving
    torch.cuda.empty_cache()
    ops = build_radial_ops()
    spmm_rec = phase_spmm_kernels(ops)
    k3_launches = phase_radial(ops)
    k4_launches = phase_radial_bell(ops)
    grad_part("radial", ops, grads)
    # the 256^2 radial operator waits on the host for phase 10 (d)
    radial = (ops[RADIAL_N].to("cpu"), ops["x_true"][RADIAL_N])
    del ops
    torch.cuda.empty_cache()
    k2_worst, k2_timing = phase_toeplitz_kernels()
    tree, k2_launches = phase_tree_path()
    phase_tree_cross_checks(tree)
    grad_part("tree", tree, grads)
    maps = tree["maps"]
    del tree
    torch.cuda.empty_cache()
    x_true = phantom(N)
    roofline = phase_cartesian(maps, x_true)
    torch.cuda.empty_cache()
    phase_fista(maps, x_true)
    del maps, x_true
    torch.cuda.empty_cache()
    launches += phase_sharded()
    rest = phase_rest(roofline, serving_s_per_iter, radial)
    launches += rest["k1"]
    k3_launches += rest["k3"]
    boundary = phase_boundary()
    launches += boundary["k1"]
    k2_launches += boundary["k2"]
    k3_launches += boundary["k3"]
    k4_launches += boundary["k4"]
    grad_part("kernels", None, grads)
    print("[grad_summary] " + " ".join(f"{k}_launches={v}"
                                        for k, v in grads.items())
          + f" card={card_line()!r}", flush=True)
    launches += grads["k1"]
    k2_launches += grads["k2"]
    k3_launches += grads["k3"]
    k4_launches += grads["k4"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(name, source, replaces, launches, worst, t):
        return dict({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": worst}, **{k: t[k] for k in keys})

    toeplitz_src = "indigo_tpu_torch/csrc/sense_normal.cu"
    spmm_src = "indigo_tpu_torch/csrc/block_spmm.cu"
    record = {"kernels": [
        entry("sense_normal_cuda (K1, three passes)", toeplitz_src,
              "indigo_tpu/ops/dft_pallas.py:643", launches, worst,
              timing[256]),
        entry("toeplitz_apply_cuda (K2, three passes)", toeplitz_src,
              "indigo_tpu/ops/dft_pallas.py:759", k2_launches, k2_worst,
              k2_timing[256]),
        entry("jag_spmm_cuda (K3)", spmm_src, "indigo_tpu/ops/ell_spmm.py:109",
              k3_launches, spmm_rec["jag"]["max_abs_err"], spmm_rec["jag"]),
        entry("ell_spmm_cuda (K4)", spmm_src, "indigo_tpu/ops/ell_spmm.py:61",
              k4_launches, spmm_rec["bell"]["max_abs_err"],
              spmm_rec["bell"]),
        entry("pad_idft_cuda (adjoint pad-DFT, one pass per axis)",
              "indigo_tpu_torch/csrc/pad_dft.cu",
              "none (indigo_tpu/ops/dft_fft.py dft_nd_apply: XLA matmuls)",
              pad_launches, pad_worst, pad_timing),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # report the phase that failed, exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
