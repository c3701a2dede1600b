"""The port's native C++ gridding code against the reference's, bit for
bit, and its build: on first use, into the package's build directory,
concurrently from several processes, loudly when g++ fails.

It also holds what the port's other parity tests pin the gridding builder
with (``builder``, ``pin_builder``): the reference's loader builds onto one
file from every process, so under several test workers one of them can load
a library another is still writing and take the numpy build for the rest of
its life, while the port's builder, which renames a whole library into
place, gives it the C++ one. The two builds differ by one ulp in some of the
weights, which a solve can carry to its bar. So each parity test runs
both packages on a builder it chose, never on the one the race left."""
import ctypes
import filecmp
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from indigo_tpu import native as jnat
from indigo_tpu import noncart as jnc
from indigo_tpu_torch import native
from indigo_tpu_torch import noncart as tnc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the two builds a parity test can pin; "mixed" (the reference on numpy, the
# port on native) is the pairing the race leaves
BUILDERS = ["native", "numpy"]


def _reference_library():
    """The reference's ``gridding.cpp`` compiled with its own command into a
    path under the port's build directory (a temporary name, then
    ``os.replace``, as the port's builder does), and loaded with the
    reference's declarations. None when g++ fails.

    ``test_source_is_the_reference_copy`` holds the port's source and flags
    equal to the reference's, so this is the reference's own library, whole,
    whatever its loader did."""
    h = hashlib.sha256(" ".join(native._CMD).encode())
    with open(jnat._SRC, "rb") as f:
        h.update(f.read())
    name = f"libindigo_reference_gridding.{h.hexdigest()[:16]}.so"
    path = os.path.join(native._OUT, name)
    if not os.path.exists(path):
        os.makedirs(native._OUT, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(native._CMD + [jnat._SRC, "-o", tmp], check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.kb_interp_ell.restype = ctypes.c_int64
    lib.kb_interp_ell.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
    ]
    lib.native_num_threads.restype = ctypes.c_int32
    return lib


def pin_reference(monkeypatch, name):
    """Put ``interp_mat(impl="auto")`` of the reference on build ``name``
    for this test, whatever its loader did: "native" installs
    ``_reference_library()`` as its ``_lib`` (skips where g++ is missing),
    "numpy" makes its ``available()`` False."""
    if name == "native":
        lib = _reference_library()
        if lib is None:
            pytest.skip("g++ did not build the reference's native library")
        monkeypatch.setattr(jnat, "_lib", lib)
    monkeypatch.setattr(jnat, "available", lambda: name == "native")


def pin_builder(monkeypatch, name):
    """Pin ``interp_mat(impl="auto")`` of both packages for this test:
    "native" or "numpy" in both, or "mixed", the reference on numpy and the
    port on native. Where the port's library does not build (no g++), both
    take numpy, as ``impl="auto"`` does there. Returns the pairing in
    effect."""
    port = name != "numpy" and native.available()
    ref = port and name == "native"
    pin_reference(monkeypatch, "native" if ref else "numpy")
    if not port:
        monkeypatch.setattr(native, "available", lambda: False)
    return "native" if ref else "mixed" if port else "numpy"


@pytest.fixture
def builder(request, monkeypatch):
    """The gridding build both packages run on in this test: "native"
    unless the test parametrizes it (``indirect=True``) over ``BUILDERS``
    or "mixed". Its value is the pairing in effect (``pin_builder``)."""
    return pin_builder(monkeypatch, getattr(request, "param", "native"))


def _both_load(monkeypatch):
    if not native.available():
        pytest.skip(f"the port's native library did not build: "
                    f"{native._error}")
    pin_reference(monkeypatch, "native")


def _equal(a, b):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_source_is_the_reference_copy():
    assert filecmp.cmp(os.path.join(ROOT, "indigo_tpu_torch", "native",
                                    "gridding.cpp"),
                       os.path.join(ROOT, "indigo_tpu", "native",
                                    "gridding.cpp"), shallow=False)
    assert native._CMD == ["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
                           "-std=c++17"]


@pytest.mark.parametrize("ndim,grid", [(1, (64,)), (2, (32, 48)),
                                       (3, (16, 16, 16))])
@pytest.mark.parametrize("width", [3, 4, 6])
def test_native_matches_reference_native(ndim, grid, width, rng,
                                         monkeypatch):
    _both_load(monkeypatch)
    traj = rng.random((200, ndim)) - 0.5
    beta = tnc.beatty_beta(width, 1.5)
    a = tnc.interp_mat(traj, grid, width=width, beta=beta, impl="native")
    _equal(a, jnc.interp_mat(traj, grid, width=width, beta=beta,
                             impl="native"))
    # and against the numpy build: one f32 rounding of a weight apart
    b = tnc.interp_mat(traj, grid, width=width, beta=beta, impl="numpy")
    assert a.nnz == b.nnz and abs(a - b).max() < 1e-5


@pytest.mark.parametrize("d", [2, 3])
def test_auto_equals_reference_auto(rng, d, monkeypatch):
    """The default build is the reference's default build: equal arrays
    (the numpy build differs from it by one ulp in about a third of the
    weights)."""
    _both_load(monkeypatch)
    traj = rng.random((500, d)) - 0.5
    grid = (24,) * d
    a = tnc.interp_mat(traj, grid, width=4)
    _equal(a, jnc.interp_mat(traj, grid, width=4))
    c = tnc.interp_mat(traj, grid, width=4, impl="numpy")
    assert (a != c).nnz > 0 and abs(a - c).max() < 1e-7


@pytest.mark.parametrize("impl", BUILDERS)
def test_each_build_is_the_reference_s_and_one_ulp_from_the_other(
        impl, monkeypatch):
    """On the doubled grid of tests/test_torch_halo.py's 40^2 SenseRecon
    (100^2, width 4, the beta of oversampling 1.25): each build of the port
    equals the reference's bitwise, and the native build differs from the
    numpy one, by at most 1e-7 of the largest weight."""
    from test_torch_recon import radial_traj

    if impl == "native":
        _both_load(monkeypatch)
    traj, grid = radial_traj(60, 80), (100, 100)
    kw = dict(width=4, beta=tnc.beatty_beta(4, 1.25))
    a = tnc.interp_mat(traj, grid, impl=impl, **kw)
    _equal(a, jnc.interp_mat(traj, grid, impl=impl, **kw))
    if impl == "native":
        b = tnc.interp_mat(traj, grid, impl="numpy", **kw)
        d = abs(a - b).max() / abs(b).max()
        assert (a != b).nnz > 0 and d <= 1e-7, d


def test_native_wraparound(monkeypatch):
    """Samples at the edge of k-space wrap periodically, as in numpy."""
    _both_load(monkeypatch)
    traj = np.array([[-0.4999], [0.4999], [0.0]])
    a = tnc.interp_mat(traj, (32,), width=4, impl="native")
    _equal(a, jnc.interp_mat(traj, (32,), width=4, impl="native"))
    assert abs(a - tnc.interp_mat(traj, (32,), width=4,
                                  impl="numpy")).max() < 1e-5
    assert set(a[0].indices) >= {0, 31}


def test_threads_and_arguments_it_rejects(monkeypatch):
    _both_load(monkeypatch)
    assert native.num_threads() >= 1
    traj = np.zeros((3, 2))
    assert native.kb_interp_ell(traj, (8, 8), 1, 2.0) is None   # width < 2
    with pytest.raises(ValueError):
        native.kb_interp_ell(traj, (8, 8, 8), 4, 2.0)
    with pytest.raises(ValueError):
        tnc.interp_mat(traj, (8, 8), impl="fortran")


def test_without_the_library(monkeypatch, rng):
    """No library: 'auto' takes the numpy build, 'native' raises with the
    reason."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_error", "g++ failed (rc 1): no compiler")
    assert not native.available()
    traj = rng.random((50, 2)) - 0.5
    _equal(tnc.interp_mat(traj, (16, 16)),
           tnc.interp_mat(traj, (16, 16), impl="numpy"))
    with pytest.raises(RuntimeError, match="no compiler"):
        tnc.interp_mat(traj, (16, 16), impl="native")


def test_a_failed_build_says_why(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(native, "_OUT", str(tmp_path))
    monkeypatch.setattr(native, "_CMD", native._CMD + ["-fno-such-flag"])
    monkeypatch.setattr(native, "_error", None)
    assert native.build() is None
    assert "no-such-flag" in native._error
    assert "build failed" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []       # no partial library left


_BUILD_AND_CHECK = """
import sys
import numpy as np
from indigo_tpu_torch import native, noncart
native._OUT = sys.argv[1]
path = native.build()
lib = native._open(path)
traj = np.random.default_rng(0).random((400, 3)) - 0.5
cols, wts = native._interp_ell(lib, traj, (12, 12, 12), 4, 6.0)
ref = noncart.interp_mat(traj, (12, 12, 12), width=4, beta=6.0,
                         impl="numpy")
got = noncart.sp.csr_matrix((wts.ravel(), cols.ravel(),
                             np.arange(401) * 64), shape=ref.shape)
got.sum_duplicates()
assert abs(got - ref).max() < 1e-5, "wrong weights"
print(path)
"""


def test_concurrent_first_builds(tmp_path):
    """Two processes build into one fresh directory at once: each compiles
    into its own temporary name and renames it into place, so both load a
    whole library, and only the library is left."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_CHECK,
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths.pop())]
