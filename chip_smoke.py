"""Smoke run of indigo_tpu_torch on one NVIDIA GPU: kernels and main path.

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


def main():
    phase_device()
    phase_build()
    worst, timing = phase_kernels()
    launches = phase_main_path()
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
