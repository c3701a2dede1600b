"""Smoke run of indigo_tpu_torch on one NVIDIA GPU: kernels and main paths.

    python3 chip_smoke.py

Phases (each prints one line with its numbers and seconds; any failure
raises and exits non-zero):
  0. device: requires CUDA (there is no CPU fallback); prints the card, its
     power limit (nvidia-smi), torch and CUDA versions.
  1. build: compiles the CUDA kernels from csrc/ (nvcc, first use).
  2. kernel vs plain: sense_normal_cuda against sense_normal_reference on the
     card at 8^3 .. 256^3 (rel_err <= 1e-4), and both times at 128^3/nc=8 and
     256^3/nc=4.
  3. main path: SenseRecon at the serving-lane size (256^3, 8 coils, 4096 x
     256 kooshball = 1,048,576 samples per coil, oversamp 1.25, width 4,
     10 CG iterations, coil_chunk 4) on the GPU: 3 acquisitions of a noisy
     smooth phantom, the same 3 through ``stream``, then the noise-free
     data once. Checks finite, decreasing residuals, a finite image, the
     kernel launch count and that the plain normal op never ran on the GPU;
     a small problem is also reconstructed on the GPU and on the CPU and the
     two compared.
  4. spmm kernels: K3 (jag_spmm_cuda) and K4 (ell_spmm_cuda) against their
     plain versions on the card (rel_err <= 1e-5): small shapes at bm 8, 16
     and 128, then the radial path's own matrices (G and G^H at 256^2 as
     jag, G as ELL at 256^2, G^H as ELL at 128^2; 16 real columns), with
     kernel and plain ms (plain, kernel, kernel, plain).
  5. radial 2D path: the reference's 2D radial CG-SENSE recipe at 256^2,
     8 coils, 384 spokes x 512 readout points (196,608 samples per coil),
     oversamp 1.5 (grid 384^2), width 4: sense_nufft_op(interp="sparse") on
     the GPU, y = A x + 1 % noise, A^H y, then two solves of
     cg(A^H A, lamda=0.1, tol=0, maxiter=30, history=True). Checks finite,
     decreasing residuals, a finite image, the K3 launch count and that no
     SpMM took the plain path on the GPU; the same recipe at 64^2/4 coils on
     the GPU and on the CPU (<= 1e-4); and a 128^2 solve whose gridding leaf
     is blocked-ELL (K4) against the jag (K3) solve (<= 1e-4).
The line before the last holds the per-kernel JSON record; the last line is
the result object.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

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


def phase_device():
    t0 = time.time()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", t0, name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)


def phase_build():
    t0 = time.time()
    from indigo_tpu_torch.ops._build import load_library, build_dir
    load_library()
    with open(os.path.join(build_dir(), "build.log")) as f:
        regs = [ln.strip() for ln in f if "registers" in ln]
    log("build", t0, ptxas="|".join(regs))


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


def phase_kernels():
    import torch
    from indigo_tpu_torch.ops.dft_cuda import (
        kernel_spectrum, sense_normal_cuda, sense_normal_reference)
    from indigo_tpu_torch.utils import rand64c, rel_err

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    cases = [((8, 8, 8), 1, 2), ((8, 16, 24), 2, 3), ((16, 136, 8), 1, 2),
             ((128, 128, 128), 1, 8), ((256, 256, 256), 1, 4)]
    worst = 0.0
    timing = {}
    for shape, S, nc in cases:
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
            reps = 5 if shape[0] == 128 else 3
            # plain, kernel, kernel, plain: drift shows up as a split
            p1 = timed(lambda: sense_normal_reference(T, m, v), reps)
            k1 = timed(lambda: sense_normal_cuda(T, m, v), reps)
            k2 = timed(lambda: sense_normal_cuda(T, m, v), reps)
            p2 = timed(lambda: sense_normal_reference(T, m, v), reps)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            sense_normal_cuda(T, m, v, events=ev)
            torch.cuda.synchronize()
            per = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
            timing[shape[0]] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
            fields.update(kernel_ms=f"{k1:.2f},{k2:.2f}",
                          plain_ms=f"{p1:.2f},{p2:.2f}",
                          a_b_c_ms=",".join(f"{x:.2f}" for x in per))
        del T, m, v
        torch.cuda.empty_cache()
        log("kernel", t0, **fields)
    return worst, timing


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


def phase_main_path():
    import torch
    from indigo_tpu_torch.models import SenseRecon
    from indigo_tpu_torch.ops.dft_cuda import (
        sense_normal_cuda, sense_normal_reference)
    from indigo_tpu_torch.utils import rel_err

    small_path_check()
    t0 = time.time()
    traj = kooshball_traj(NSPOKES, NREAD, seed=SEED)
    maps = coil_maps(N, NC, seed=SEED)
    M = len(traj)
    log("data", t0, samples_per_coil=M, coils=NC, shape=f"{N}^3")

    torch.cuda.reset_peak_memory_stats()
    sense_normal_cuda.launches = 0
    sense_normal_reference.cuda_calls = 0
    t0 = time.time()
    recon = SenseRecon(traj, maps, oversamp=OVERSAMP, width=WIDTH,
                       iters=ITERS, coil_chunk=COIL_CHUNK, device="cuda")
    torch.cuda.synchronize()
    if recon.layout != "kernel":
        raise AssertionError(f"main path layout {recon.layout}")
    if sense_normal_cuda.launches != 0:
        raise AssertionError("the pipeline build launched the normal op")
    log("init", t0, layout=recon.layout, lamda=f"{recon.lamda:.4g}")

    t0 = time.time()
    x_true = phantom(N)
    y0 = recon.simulate(x_true)
    rng = np.random.default_rng(SEED + 1)
    # complex white noise at 1% of the k-space RMS (40 dB SNR)
    sigma = 0.01 * float(np.sqrt(np.mean(np.abs(y0) ** 2) / 2))
    ys = [y0 + sigma * (rng.standard_normal(y0.shape, dtype=np.float32)
                        + 1j * rng.standard_normal(y0.shape,
                                                   dtype=np.float32))
          for _ in range(3)]
    log("simulate", t0, samples=y0.shape[0])

    per_solve = 3 * ITERS * (NC // COIL_CHUNK)
    times = []
    for i, y in enumerate(ys):
        t0 = time.time()
        before = sense_normal_cuda.launches
        x, res = recon(y, return_resids=True)
        times.append(time.time() - t0)
        grew = sense_normal_cuda.launches - before
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
    out = list(recon.stream(ys))
    t_stream = (time.time() - t0) / len(out)
    if sense_normal_cuda.launches - before != len(ys) * per_solve:
        raise AssertionError("stream launch count")
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
    if sense_normal_reference.cuda_calls != 0:
        raise AssertionError("the plain normal op ran on the GPU")
    print(f"[summary] first_s={times[0]:.3f} warm_s="
          f"{','.join(f'{t:.3f}' for t in times[1:])} stream_s_per_acq="
          f"{t_stream:.3f} launches={sense_normal_cuda.launches} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
    return sense_normal_cuda.launches


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
                             interp="sparse")
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
        sense_normal_cuda, sense_normal_reference)
    from indigo_tpu_torch.ops.ell_spmm import ell_spmm_cuda, jag_spmm_cuda
    for fn in (sense_normal_cuda, jag_spmm_cuda, ell_spmm_cuda):
        fn.launches = 0
    sense_normal_reference.cuda_calls = 0
    spmm.plain_cuda_calls = 0


def phase_spmm_kernels(ops):
    """K3 and K4 against their plain versions: small shapes, then the
    radial path's matrices. Returns per-kernel worst abs error and times."""
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

    def check(fmt, mat, x, label, time_it=False, **fields):
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
        rec[fmt]["max_abs_err"] = max(rec[fmt]["max_abs_err"], abs_err)
        fields.update(kernel=kern.__name__, at=label, bm=mat.bm,
                      fill=f"{mat.fill_fraction():.4f}",
                      rel_err=f"{err:.3e}", max_abs_err=f"{abs_err:.3e}")
        if time_it:
            p1 = timed(lambda: plain(mat, x), 10)
            k1 = timed(lambda: kern(mat, x), 20)
            k2 = timed(lambda: kern(mat, x), 20)
            p2 = timed(lambda: plain(mat, x), 10)
            fields.update(kernel_ms=f"{k1:.4f},{k2:.4f}",
                          plain_ms=f"{p1:.4f},{p2:.4f}")
            return fields, (k1 + k2) / 2, (p1 + p2) / 2
        log("spmm", t0, **fields)
        return fields, None, None

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
    ell256 = csr_to_bell(jag_to_csr(G256.ell)).to(dev)
    ellH128 = csr_to_bell(jag_to_csr(G128.ellH)).to(dev)
    log("spmm_build_ell", t0, G256=f"{ell256.R}x{ell256.W}",
        GH128=f"{ellH128.R}x{ellH128.W}",
        gb=f"{(ell256.memusage() + ellH128.memusage()) / 1e9:.2f}")
    cases = [("jag", G256.ell, f"G {RADIAL_N}^2"),
             ("jag", G256.ellH, f"G^H {RADIAL_N}^2"),
             ("bell", ell256, f"G-ELL {RADIAL_N}^2"),
             ("bell", ellH128, "G^H-ELL 128^2")]
    for fmt, mat, label in cases:
        t0 = time.time()
        x = torch.from_numpy(rng.standard_normal(
            (mat.shape[1], K), dtype=np.float32)).to(dev)
        size = (dict(NB=mat.NB) if fmt == "jag"
                else dict(R=mat.R, W=mat.W))
        fields, ms, plain_ms = check(fmt, mat, x, label, time_it=True,
                                     **size)
        log("spmm", t0, **fields)
        # the main path's shapes: G at 256^2, as jag (K3) and as ELL (K4)
        if label.startswith("G ") or label.startswith("G-ELL"):
            rec[fmt].update(ms=ms, plain_ms=plain_ms)
    del ell256, ellH128
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


def main():
    phase_device()
    phase_build()
    worst, timing = phase_kernels()
    launches = phase_main_path()
    ops = build_radial_ops()
    spmm_rec = phase_spmm_kernels(ops)
    k3_launches = phase_radial(ops)
    k4_launches = phase_radial_bell(ops)
    import torch
    t256 = timing[256]
    record = {"kernels": [{
        "name": "sense_normal_cuda (kernels A, B, C)",
        "route": "cuda",
        "source": "indigo_tpu_torch/csrc/sense_normal.cu",
        "replaces": "indigo_tpu/ops/dft_pallas.py:643",
        "launches": launches,
        "max_abs_err": worst,
        "ms": t256["ms"],
        "plain_ms": t256["plain_ms"],
    }, {
        "name": "jag_spmm_cuda (K3)",
        "route": "cuda",
        "source": "indigo_tpu_torch/csrc/block_spmm.cu",
        "replaces": "indigo_tpu/ops/ell_spmm.py:109",
        "launches": k3_launches,
        "max_abs_err": spmm_rec["jag"]["max_abs_err"],
        "ms": spmm_rec["jag"]["ms"],
        "plain_ms": spmm_rec["jag"]["plain_ms"],
    }, {
        "name": "ell_spmm_cuda (K4)",
        "route": "cuda",
        "source": "indigo_tpu_torch/csrc/block_spmm.cu",
        "replaces": "indigo_tpu/ops/ell_spmm.py:61",
        "launches": k4_launches,
        "max_abs_err": spmm_rec["bell"]["max_abs_err"],
        "ms": spmm_rec["bell"]["ms"],
        "plain_ms": spmm_rec["bell"]["plain_ms"],
    }]}
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
