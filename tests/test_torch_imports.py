"""indigo_tpu_torch stands alone: it imports neither jax nor indigo_tpu (the
GPU machine has no jax), and builds no kernel at import time."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "indigo_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "indigo_tpu")
GPU_ONLY = ("triton",)


def _sources():
    out = []
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_jax_out():
    code = ("import sys, indigo_tpu_torch, indigo_tpu_torch.models, "
            "indigo_tpu_torch.ops.dft_cuda, indigo_tpu_torch.convert, "
            "indigo_tpu_torch.ops.pad_dft_cuda, "
            "indigo_tpu_torch.sparse, indigo_tpu_torch.solvers, "
            "indigo_tpu_torch.ops.ell_spmm, indigo_tpu_torch.toeplitz, "
            "indigo_tpu_torch.noncart, indigo_tpu_torch.ops.toeplitz_fft, "
            "indigo_tpu_torch.parallel.recon, indigo_tpu_torch.operators, "
            "indigo_tpu_torch.transforms, indigo_tpu_torch.wavelet, "
            "indigo_tpu_torch.oracle, indigo_tpu_torch.models.sense, "
            "indigo_tpu_torch.ops.tile_interp, indigo_tpu_torch.utils, "
            "indigo_tpu_torch.analyses, indigo_tpu_torch.parallel.mesh, "
            "indigo_tpu_torch.parallel.collectives, "
            "indigo_tpu_torch.parallel.dist_fft, "
            "indigo_tpu_torch.parallel.e2e, "
            "indigo_tpu_torch.parallel.launch, "
            "indigo_tpu_torch.parallel.dryrun, indigo_tpu_torch.backends, "
            "indigo_tpu_torch.native, indigo_tpu_torch.profiling, "
            "indigo_tpu_torch.checkpoint, indigo_tpu_torch.examples, "
            "indigo_tpu_torch.examples.cartesian_sense_2d, "
            "indigo_tpu_torch.examples.radial_sense_2d, "
            "indigo_tpu_torch.examples.multicoil_3d, "
            "indigo_tpu_torch.examples.cs_wavelet_fista, "
            "indigo_tpu_torch.examples.serving_pipeline\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + GPU_ONLY!r}]\n"
            "print(','.join(bad))\n"
            "assert 'indigo_tpu_torch.ops._build' not in sys.modules\n"
            "from indigo_tpu_torch import native\n"
            "assert native._lib is None and not native._tried\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", res.stdout


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_source_has_no_jax_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_chip_smoke_has_no_jax_import():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, n
