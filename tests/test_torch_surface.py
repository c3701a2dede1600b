"""The port's public surface against the reference's: ``Operator * ndarray``
(1e-5), the names the reference's ``__init__`` files export, every
parameter name of every reference callable and public method, and the
reference-shaped calls with TPU-only knobs, which the port accepts.
"""
import numpy as np
import pytest
import torch

import indigo_tpu as jit_
import indigo_tpu_torch as tit
from indigo_tpu.utils import randM
from indigo_tpu_torch.utils import rand64c, rel_err


# ---- Operator * numpy.ndarray ------------------------------------------

def _ops(rng):
    M = randM(40, 30, 0.2, rng=rng)
    D = rand64c(40, 30, rng=rng)
    return [(tit.SpMatrix(M, device="cpu"), jit_.SpMatrix(M)),
            (tit.DenseMatrix(D, device="cpu"), jit_.DenseMatrix(D)),
            (tit.DenseMatrix(D, device="cpu").H
             * tit.SpMatrix(M, device="cpu"),
             jit_.DenseMatrix(D).H * jit_.SpMatrix(M))]


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("ndim", [1, 2])
def test_operator_times_ndarray(rng, i, ndim):
    op, ref = _ops(rng)[i]
    x = rand64c(*((30,) if ndim == 1 else (30, 3)), rng=rng)
    y = op * x
    assert isinstance(y, torch.Tensor) and y.dtype == torch.complex64
    want = np.asarray(ref * x)
    assert tuple(y.shape) == want.shape
    assert rel_err(y, want) < 1e-5
    assert torch.equal(op @ x, y)
    assert torch.equal(op * torch.from_numpy(x), y)
    back = op.H * np.asarray(want)
    assert rel_err(back, np.asarray(ref.H * want)) < 1e-5


def test_operator_times_ndarray_errors(rng):
    op, _ = _ops(rng)[0]
    with pytest.raises(ValueError):
        op * rand64c(31, rng=rng)
    with pytest.raises(TypeError):
        rand64c(40, rng=rng) * op       # no elementwise object array
    with pytest.raises(TypeError):
        op * "x"
    assert isinstance(2.0 * op, tit.Scale) and isinstance(op * 2, tit.Scale)


# ---- exported names ------------------------------------------------------

OPERATORS = ["Operator", "SpMatrix", "KBInterp", "DenseMatrix", "Diag",
             "UnscaledFFT", "CenteredDFT", "GridDFT", "Eye", "One", "Mask",
             "CropPad", "Perm", "Product", "Adjoint", "KronI", "BlockDiag",
             "VStack", "HStack", "Scale"]
TOP = OPERATORS + ["cg", "apgd", "fista", "max_eigen", "soft_thresh", "DWT",
                   "BlockedELL", "csr_to_bell", "bell_spmm", "get_backend",
                   "available_backends"]
SUBMODULES = ["operators", "transforms", "solvers", "sparse", "utils",
              "noncart", "oracle", "models", "wavelet", "toeplitz",
              "parallel", "backends", "native", "profiling", "checkpoint"]


@pytest.mark.parametrize("name", TOP + SUBMODULES)
def test_top_level_name_resolves(name):
    assert hasattr(jit_, name)          # the reference exports it
    assert hasattr(tit, name), name
    assert name in tit.__all__


def test_operator_exports_equal_the_reference():
    import indigo_tpu.operators as jo
    import indigo_tpu_torch.operators as to
    assert sorted(to.__all__) == sorted(jo.__all__) == sorted(OPERATORS)
    import indigo_tpu.solvers as js
    import indigo_tpu_torch.solvers as ts
    assert sorted(ts.__all__) == sorted(js.__all__)
    import indigo_tpu.transforms as jt
    import indigo_tpu_torch.transforms as tt
    assert sorted(tt.__all__) == sorted(jt.__all__)
    import indigo_tpu.models as jm
    import indigo_tpu_torch.models as tm
    assert sorted(tm.__all__) == sorted(jm.__all__)
    import indigo_tpu.wavelet as jw
    import indigo_tpu_torch.wavelet as tw
    assert sorted(tw.__all__) == sorted(jw.__all__)


def test_subpackage_exports():
    import indigo_tpu.analyses as ja
    import indigo_tpu.parallel as jp
    import indigo_tpu.utils as ju
    import indigo_tpu_torch.analyses as ta
    import indigo_tpu_torch.parallel as tp
    import indigo_tpu_torch.utils as tu
    for j, t in ((jp, tp), (ja, ta), (ju, tu)):
        assert sorted(t.__all__) == sorted(j.__all__)
        for name in j.__all__:
            assert hasattr(t, name), (t.__name__, name)
    assert len(tp.__all__) == 14
    from indigo_tpu_torch.noncart import zpad_mat, checkerboard  # noqa: F401
    assert tit.Diag(np.ones(3, np.complex64), device="cpu").shape == (3, 3)


# every name the reference exports: in the port, or dropped with a reason ---

# reference module -> its counterpart in the port (None: no counterpart)
COUNTERPART = {"cplx": None, "ops.dft_pallas": "ops.dft_cuda"}

_CPLX = ("torch holds complex64 natively on the card; the reference's split "
         "re/im planes (its device boundary) have no use")
_TILED = ("the TPU's 128-lane tiled-grid layout; the port grids on the "
          "natural-order grid (ops.tile_interp.kb_gather / kb_scatter)")
# (reference module, name) -> (reason, the port's counterpart or None)
DROPPED = {
    **{("cplx", n): (_CPLX, None) for n in (
        "CPair", "pack", "unpack", "as_payload", "iscpair", "conj",
        "to_numpy", "cjit", "device_put_tree", "supports_complex_buffers",
        "eager_call")},
    ("ops.dft_fft", "tiled_idft_apply"): (_TILED, None),
    ("ops.tile_interp", "tile_grid"): (_TILED, None),
    ("ops.tile_interp", "untile_grid"): (_TILED, None),
    ("ops.tile_interp", "tile_forward_tiled"): (_TILED, None),
    ("ops.tile_interp", "tile_adjoint_tiled"): (_TILED, None),
    ("ops.tile_interp", "bin_layout_of"): (
        "the tiled adjoint's bin layout; the port's adjoint is one "
        "index_add_ scatter", None),
    ("ops.tile_interp", "merge_bin_layouts"): (
        "the tiled adjoint's bin layout", None),
    ("ops.tile_interp", "build_tile_adj_bins"): (
        "the tiled adjoint's bin layout", None),
    ("ops.dft_pallas", "pallas_spectrum"): (
        "a Pallas name: the CUDA kernels read the block layout in (Z, Y, X) "
        "order", "kernel_spectrum"),
    ("ops.dft_pallas", "toeplitz_apply_pallas"): (
        "a Pallas name: K2 is the CUDA kernel", "toeplitz_apply_cuda"),
    ("ops.dft_pallas", "sense_normal_pallas"): (
        "a Pallas name: K1 is the CUDA kernel", "sense_normal_cuda"),
    ("ops.dft_pallas", "pallas_supported"): (
        "a Pallas name: the volumes the CUDA kernels take", "supported"),
    ("ops.ell_spmm", "ell_spmm_pallas"): (
        "a Pallas name: K4 is the CUDA kernel", "ell_spmm_cuda"),
    ("ops.ell_spmm", "jag_spmm_pallas"): (
        "a Pallas name: K3 is the CUDA kernel", "jag_spmm_cuda"),
}

REFERENCE_MODULES = [
    "analyses", "backends", "checkpoint", "cplx", "models", "models.recon",
    "models.sense", "native", "noncart", "operators", "ops", "ops.dft_fft",
    "ops.dft_pallas", "ops.ell_spmm", "ops.tile_interp", "ops.toeplitz_fft",
    "oracle", "parallel", "parallel.dist_fft", "parallel.e2e",
    "parallel.mesh", "parallel.recon", "profiling", "solvers", "sparse",
    "toeplitz", "transforms", "utils", "wavelet"]


def test_reference_modules_with_all_are_listed():
    import importlib
    import pkgutil
    found = []
    for info in pkgutil.walk_packages(jit_.__path__, "indigo_tpu."):
        if info.name.rsplit(".", 1)[-1].startswith("_"):
            continue            # private, and the native build's .so
        mod = importlib.import_module(info.name)
        if hasattr(mod, "__all__"):
            found.append(info.name[len("indigo_tpu."):])
    assert sorted(found) == sorted(REFERENCE_MODULES)


@pytest.mark.parametrize("module", REFERENCE_MODULES)
def test_every_reference_export_resolves_or_is_dropped(module):
    """Each name in the reference module's ``__all__`` resolves in the
    port's counterpart, or stands in ``DROPPED`` with its reason; a dropped
    name does not resolve, and its counterpart, where it has one, does."""
    import importlib
    ref = importlib.import_module(f"indigo_tpu.{module}")
    port_name = COUNTERPART.get(module, module)
    port = (None if port_name is None else
            importlib.import_module(f"indigo_tpu_torch.{port_name}"))
    for (mod, name), (reason, instead) in DROPPED.items():
        if mod != module:
            continue
        assert hasattr(ref, name) and reason, (module, name)
        assert port is None or not hasattr(port, name), (module, name)
        assert instead is None or hasattr(port, instead), (module, instead)
    missing = [n for n in ref.__all__ if (port is None or
               not hasattr(port, n)) and (module, n) not in DROPPED]
    assert not missing, (module, missing)


# every reference parameter name is taken by the port ---------------------

# what the port leaves out of the reference's call forms, each with its
# reason: (module, callable) -> (parameter names, or None for the whole
# method, reason). The names in DROPPED are left out with their module's.
_PYTREE = ("JAX's pytree protocol; the port's operators, formats and plans "
           "are nn.Modules or plain host objects")
_MATS = ("private: the reference's unflatten hands its prebuilt DFT "
         "matrices back in; the port's leaf keeps them as buffers")
SIGNATURE_DROPPED = {
    "tree_flatten": (None, _PYTREE),        # on every class that has it
    "tree_unflatten": (None, _PYTREE),
    ("sparse", "BlockedJag.smem_ok"): (
        None, "whether the block index arrays fit the TPU's SMEM; a CUDA "
        "kernel has no such budget (csr_to_jag keeps its auto_bm rule)"),
    ("operators", "CenteredDFT"): ({"_mats"}, _MATS),   # its constructor
    ("operators", "GridDFT"): ({"_mats"}, _MATS),
}
# Not a difference of name: max_eigen(key=) takes an int seed or a
# torch.Generator where the reference takes a PRNGKey.


def _signature_cases():
    """(module, callable) for every callable in every reference __all__
    (a class: its constructor and properties) and every public method of
    its classes, ``Class.method``."""
    import importlib
    import inspect
    cases = []
    for module in REFERENCE_MODULES:
        if COUNTERPART.get(module, module) is None:
            continue
        ref = importlib.import_module(f"indigo_tpu.{module}")
        for name in ref.__all__:
            obj = getattr(ref, name)
            if (module, name) in DROPPED or not callable(obj):
                continue
            cases.append((module, name))
            if inspect.isclass(obj):
                cases += [(module, f"{name}.{m}") for m in dir(obj)
                          if not m.startswith("_")
                          and not isinstance(inspect.getattr_static(obj, m),
                                             property)
                          and callable(getattr(obj, m))]
    return cases


def _parameters(fn):
    """(names, takes **kwargs) of fn's signature."""
    import inspect
    ps = inspect.signature(fn).parameters.values()
    return ({p.name for p in ps if p.kind not in (p.VAR_POSITIONAL,
                                                  p.VAR_KEYWORD)},
            any(p.kind == p.VAR_KEYWORD for p in ps))


def _instances():
    """A port instance of each class whose reference properties are
    instance attributes in the port."""
    from indigo_tpu_torch.ops.tile_interp import plan_tile_interp
    D = tit.Diag(np.ones(4), device="cpu")
    plan = plan_tile_interp(np.random.default_rng(0).uniform(
        -0.5, 0.5, (30, 2)), (16, 16), width=4, beta=6.5)
    return {"GridDFT": lambda: tit.GridDFT(plan, (8, 8), device="cpu"),
            "Product": lambda: D * D, "Adjoint": lambda: tit.Adjoint(D),
            "KronI": lambda: tit.KronI(2, D),
            "BlockDiag": lambda: tit.BlockDiag([D, D]),
            "VStack": lambda: tit.VStack([D, D]),
            "HStack": lambda: tit.HStack([D, D]),
            "Scale": lambda: tit.Scale(2.0, D)}


@pytest.mark.parametrize("module,qualname", _signature_cases(),
                         ids=lambda v: v)
def test_every_reference_parameter_is_accepted(module, qualname):
    """Each parameter name of the reference callable is one the port's
    counterpart takes, and each property of a reference class exists on the
    port's class or instance; else it stands in SIGNATURE_DROPPED."""
    import importlib
    import inspect
    ref = importlib.import_module(f"indigo_tpu.{module}")
    port = importlib.import_module(
        f"indigo_tpu_torch.{COUNTERPART.get(module, module)}")
    name, _, method = qualname.partition(".")
    r, p = getattr(ref, name), getattr(port, name)
    dropped, reason = SIGNATURE_DROPPED.get(
        method, SIGNATURE_DROPPED.get((module, qualname), (set(), None)))
    if method:
        if dropped is None:
            assert reason and not hasattr(p, method), qualname
            return
        r, p = getattr(r, method), getattr(p, method, None)
        assert p is not None, f"{qualname} is missing in the port"
    elif inspect.isclass(r):
        missing = [a for a in dir(r) if not a.startswith("_")
                   and isinstance(inspect.getattr_static(r, a), property)
                   and not hasattr(p, a)]
        if missing:
            inst = _instances()[name]()
            missing = [a for a in missing if not hasattr(inst, a)]
        assert not missing, (qualname, missing)
        r, p = r.__init__, (p.__init__ if inspect.isclass(p) else p)
    want, _ = _parameters(r)
    have, any_kw = _parameters(p)
    missing = sorted(want - have - dropped) if not any_kw else []
    assert not missing, (qualname, missing)
    assert not dropped or (dropped <= want and not dropped & have and
                           reason), (qualname, dropped)


def test_set_spmm_impl_and_use_pallas_match_the_reference(rng):
    """The reference's names: every impl gives the reference's product on
    the same tiles (1e-5); use_pallas says whether the kernels serve."""
    import indigo_tpu.ops as jops
    import indigo_tpu_torch.ops as tops
    from indigo_tpu_torch.convert import sparse_from_reference
    assert tops.use_pallas() == torch.cuda.is_available()
    assert jops.use_pallas() is False           # no TPU here
    M = randM(60, 300, 0.05, rng=rng, dtype=np.float32)
    x = rand64c(300, 2, rng=rng)
    ja = jit_.sparse.csr_to_jag(M)
    ta = sparse_from_reference(ja, device="cpu")
    try:
        for impl in ("jnp", "pallas", "auto"):
            jops.set_spmm_impl(impl)
            tops.set_spmm_impl(impl)
            got = tops.spmm(ta, torch.from_numpy(x))
            assert rel_err(got, np.asarray(jops.spmm(ja, x, impl="jnp"))
                           ) < 1e-5, impl
    finally:
        jops.set_spmm_impl("auto")
        tops.set_spmm_impl("auto")
    with pytest.raises(ValueError):
        tops.set_spmm_impl("cuda")


@pytest.mark.parametrize("shape", [(136, 8, 136), (8, 8, 16), (200, 12),
                                   (130,)])
@pytest.mark.parametrize("lead", [0, 1, 2])
def test_sigma_helpers_equal_the_reference(rng, shape, lead):
    import jax.numpy as jnp
    from indigo_tpu.ops import dft_pallas as jd
    from indigo_tpu_torch.ops import dft_cuda as td
    assert td.uses_sigma_basis(shape) == jd.uses_sigma_basis(shape)
    axes = td.solver_sigma_axes(shape, lead)
    assert axes == jd.solver_sigma_axes(shape, lead)
    a = rand64c(*((2,) * lead + shape), rng=rng)
    s = td.to_sigma_basis(torch.from_numpy(a), axes)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jd.to_sigma_basis(jnp.asarray(a), axes)))
    np.testing.assert_array_equal(
        td.from_sigma_basis(s, axes).numpy(),
        np.asarray(jd.from_sigma_basis(jnp.asarray(s.numpy()), axes)))
    np.testing.assert_array_equal(td.from_sigma_basis(s, axes).numpy(), a)


def test_sense_normal_batched_sigma_in_sigma_out(rng):
    """The reference's sigma contract at (136, 8, 136): sigma-basis input,
    sigma-basis output, equal to the reference's natural-order normal op
    reordered by the reference's own helper (1e-5)."""
    import jax.numpy as jnp
    from indigo_tpu.ops import dft_pallas as jd
    from indigo_tpu.ops.dft_fft import block_spectrum as j_block
    from indigo_tpu.parallel import sense_normal_batched as j_normal
    from indigo_tpu_torch.ops.dft_cuda import kernel_spectrum
    from indigo_tpu_torch.parallel import sense_normal_batched
    shape = (136, 8, 136)
    Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(np.float32)
    maps = rand64c(2, *shape, rng=rng)
    u = rand64c(1, *shape, rng=rng)
    ax = jd.solver_sigma_axes(shape)
    assert ax == (1, 3)
    want = jd.to_sigma_basis(j_normal(
        jnp.asarray(j_block(Tf)), jnp.asarray(maps), jnp.asarray(u.reshape(
            1, -1)), layout="block").reshape(u.shape), ax)
    us = np.asarray(jd.to_sigma_basis(jnp.asarray(u), ax))
    out = sense_normal_batched(kernel_spectrum(Tf), maps, us.reshape(1, -1),
                               layout="pallas", sigma=True, device="cpu")
    assert out.dtype == torch.complex64
    assert rel_err(out, np.asarray(want).reshape(1, -1)) < 1e-5


def test_toeplitz_sigma_basis_conjugation_matches_the_reference(rng):
    """K == P.H * K_sigma * P at (8, 8, 136) (1e-5): the reference's
    permutation, and the reference's operator on the same spectrum (its
    "dft" method: the same f32 math without the Pallas kernels' bf16x3
    emulation, which alone differs by ~1e-5); a no-op on non-radix
    volumes."""
    from indigo_tpu.toeplitz import ToeplitzNormal as JToeplitz
    img = (8, 8, 136)
    Tf = rng.standard_normal(tuple(2 * s for s in img)).astype(np.float32)
    K = tit.ToeplitzNormal(Tf, img, method="pallas", device="cpu")
    Ks, P = K.sigma_basis()
    Kj = JToeplitz(Tf, img, method="pallas")
    _, Pj = Kj.sigma_basis()
    assert isinstance(P, tit.Perm)
    np.testing.assert_array_equal(P.perm.numpy(), np.asarray(Pj.perm))
    x = rand64c(int(np.prod(img)), 2, rng=rng)
    lhs = np.asarray(JToeplitz(Tf, img, method="dft") * x)
    assert rel_err(K * x, lhs) < 1e-5
    assert rel_err(P.H * (Ks * (P * x)), lhs) < 1e-5
    assert rel_err(Ks * (P * x), P * lhs) < 1e-5     # Ks = P K P^H
    K64 = tit.ToeplitzNormal(Tf[:16, :16, :32], (8, 8, 16), method="pallas",
                             device="cpu")
    Ks64, P64 = K64.sigma_basis()
    assert Ks64 is K64 and P64 is None
    Kd = tit.ToeplitzNormal(Tf, img, method="dft", device="cpu")
    assert Kd.sigma_basis() == (Kd, None)


# ---- reference-shaped calls ---------------------------------------------

@pytest.mark.parametrize("grid", [(48, 64), (20, 20), (8, 8, 16)])
def test_tile_interp_apply_takes_the_reference_call(rng, grid):
    """tile_interp_apply(plan, x, adjoint, chunk) with x (N, K), against the
    reference's on the same plan geometry (1e-5)."""
    import jax.numpy as jnp
    from indigo_tpu.ops import tile_interp as jti
    from indigo_tpu_torch.ops import tile_interp as tti

    traj = rng.uniform(-0.5, 0.5, size=(120, len(grid)))
    tp = tti.plan_tile_interp(traj, grid, width=4, beta=6.5)
    jp = jti.plan_tile_interp(traj, grid, width=4, beta=6.5)
    N = int(np.prod(grid))
    x = rand64c(N, 2, rng=rng)
    y = rand64c(120, 2, rng=rng)
    fwd = tti.tile_interp_apply(tp, torch.from_numpy(x))
    assert rel_err(fwd, np.asarray(jti.tile_interp_apply(
        jp, jnp.asarray(x)))) < 1e-5
    adj = tti.tile_interp_apply(tp, y, adjoint=True, chunk=32, device="cpu")
    assert tuple(adj.shape) == (N, 2)
    assert rel_err(adj, np.asarray(jti.tile_interp_apply(
        jp, jnp.asarray(y), adjoint=True, chunk=32))) < 1e-5
    xr = x.real.copy()
    out = tti.tile_interp_apply(tp, xr, device="cpu")
    assert out.dtype == torch.float32
    assert rel_err(out, np.asarray(jti.tile_interp_apply(
        jp, jnp.asarray(xr)))) < 1e-5


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("adjoint,forward", [
    ("binned", "grouped"), ("binned", "dense"), ("scatter", "grouped"),
    ("scatter", "dense")])
def test_plan_tile_interp_takes_the_reference_keywords(adjoint, forward,
                                                       reorder):
    """Each (adjoint, forward, reorder) gives the reference plan's tid, wfac
    and sample_perm, array-equal: reorder permutes only under the grouped
    forward. On a grid with a halo axis (20 % 8) and periodic ones."""
    from indigo_tpu.ops import tile_interp as jti
    from indigo_tpu_torch.ops import tile_interp as tti
    traj = np.random.default_rng(3).uniform(-0.5, 0.5, size=(300, 3))
    kw = dict(width=4, beta=6.5, adjoint=adjoint, forward=forward,
              reorder=reorder)
    tp = tti.plan_tile_interp(traj, (20, 20, 20), **kw)
    jp = jti.plan_tile_interp(traj, (20, 20, 20), **kw)
    np.testing.assert_array_equal(tp.tid, np.asarray(jp.tid))
    for wt, wj in zip(tp.wfac, jp.wfac, strict=True):
        np.testing.assert_array_equal(wt, np.asarray(wj))
    if reorder and forward == "grouped":
        assert jp.sample_perm is not None
        np.testing.assert_array_equal(tp.sample_perm, jp.sample_perm)
    else:
        assert tp.sample_perm is None and jp.sample_perm is None
    assert tp.S == jp.S == tp.tid.shape[1]
    if (adjoint, forward) == ("scatter", "dense"):
        assert tp.memusage() == jp.memusage()


@pytest.mark.parametrize("call", ["adjoint='layout'", "adjoint='other'",
                                  "bin_layout=...", "TileInterpPlan(bins=)",
                                  "TileInterpPlan(fgroups=)"])
def test_tiled_bin_layout_is_refused(call):
    """What asks for the reference's tiled bin layout raises and says so."""
    from indigo_tpu_torch.ops import tile_interp as tti
    traj = np.random.default_rng(4).uniform(-0.5, 0.5, size=(40, 2))
    p = tti.plan_tile_interp(traj, (16, 16), width=4)
    make = {
        "adjoint='layout'": lambda: tti.plan_tile_interp(
            traj, (16, 16), adjoint="layout"),
        "adjoint='other'": lambda: tti.plan_tile_interp(
            traj, (16, 16), adjoint="other"),
        "bin_layout=...": lambda: tti.plan_tile_interp(
            traj, (16, 16), adjoint="binned", bin_layout=((1, 2),)),
        "TileInterpPlan(bins=)": lambda: tti.TileInterpPlan(
            p.tid, p.wfac, p.grid_shape, p.tile, p.ext, p.nt, p.pad_lo,
            p.width, bins=object()),
        "TileInterpPlan(fgroups=)": lambda: tti.TileInterpPlan(
            p.tid, p.wfac, p.grid_shape, p.tile, p.ext, p.nt, p.pad_lo,
            p.width, fgroups=object()),
    }[call]
    with pytest.raises(ValueError, match=_TILED.split(";")[0]):
        make()


def _dft_fft_calls(rng):
    from indigo_tpu_torch.ops import dft_fft as tdft
    v = torch.from_numpy(rand64c(2, 8, 8, 16, rng=rng))
    Tfb = torch.from_numpy(rng.standard_normal((16, 16, 32)).astype(
        np.float32))
    mats = [torch.from_numpy(tdft.centered_pad_dft_mat(n, 2 * n))
            for n in (8, 8, 16)]
    V = tdft.fft_pad2x_block(v)
    return {"dft_nd_apply": lambda **k: tdft.dft_nd_apply(v, mats, **k),
            "fft_pad2x_block": lambda **k: tdft.fft_pad2x_block(v, **k),
            "ifft_crop2x_block": lambda **k: tdft.ifft_crop2x_block(V, **k),
            "toeplitz_apply_block": lambda **k: tdft.toeplitz_apply_block(
                Tfb, v, **k)}


@pytest.mark.parametrize("name", ["dft_nd_apply", "fft_pad2x_block",
                                  "ifft_crop2x_block",
                                  "toeplitz_apply_block"])
def test_dft_fft_takes_and_ignores_precision(rng, name):
    call = _dft_fft_calls(rng)[name]
    want = call()
    for precision in ("highest", "default"):
        assert torch.equal(call(precision=precision), want), precision


def test_sense_normal_batched_takes_the_reference_layout_name(rng):
    from indigo_tpu_torch.ops.dft_fft import block_spectrum
    from indigo_tpu_torch.parallel import sense_normal_batched
    shape = (8, 8, 16)
    Tf = rng.standard_normal(tuple(2 * s for s in shape)).astype(np.float32)
    maps = torch.from_numpy(rand64c(2, *shape, rng=rng))
    xs = torch.from_numpy(rand64c(1, int(np.prod(shape)), rng=rng))
    Tb = torch.from_numpy(block_spectrum(Tf))
    a = sense_normal_batched(Tb, maps, xs, layout="pallas", sigma=False)
    b = sense_normal_batched(Tb, maps, xs, layout="kernel")
    assert torch.equal(a, b)
    # no axis over 128: the sigma basis is the natural order
    c = sense_normal_batched(Tb, maps, xs, layout="pallas", sigma=True)
    assert torch.equal(a, c)
    with pytest.raises(ValueError):     # a kernel-layout contract, as there
        sense_normal_batched(Tb, maps, xs, layout="block", sigma=True)


def test_tpu_only_knobs_are_accepted(rng, monkeypatch):
    from indigo_tpu import noncart as jn
    from indigo_tpu_torch import noncart as tn
    from indigo_tpu_torch import sparse as ts
    traj = rng.uniform(-0.5, 0.5, size=(40, 2))
    from indigo_tpu_torch import native as tnat
    from test_torch_native import pin_reference
    a = tn.interp_mat(traj, (16, 16), impl="numpy")
    b = jn.interp_mat(traj, (16, 16), impl="numpy")
    assert abs(a - b).max() < 1e-7
    auto = tn.interp_mat(traj, (16, 16), impl="auto")
    if tnat.available():
        pin_reference(monkeypatch, "native")
        assert (auto != jn.interp_mat(traj, (16, 16), impl="auto")).nnz == 0
        assert (tn.interp_mat(traj, (16, 16), impl="native") != auto).nnz == 0
    else:
        assert (auto != a).nnz == 0
        with pytest.raises(RuntimeError):
            tn.interp_mat(traj, (16, 16), impl="native")
    p = rng.permutation(9)
    P = tit.Perm(p, dtype=np.complex64, device="cpu")
    assert P.dtype == torch.complex64
    x = torch.from_numpy(rand64c(9, 2, rng=rng))
    assert torch.equal(P * x, x[torch.from_numpy(p)])
    M = randM(20, 300, 0.05, rng=rng, dtype=np.float32)
    v = torch.from_numpy(rand64c(300, 2, rng=rng))
    want = torch.from_numpy(M.toarray()).to(torch.complex64) @ v
    for conv, mm in ((ts.csr_to_jag, ts.jag_spmm),
                     (ts.csr_to_bell, ts.bell_spmm),
                     (ts.csr_to_element, ts.element_spmm)):
        assert rel_err(mm(conv(M), v, precision="highest"), want) < 1e-5


# ---- the entry points ask for the card unless told otherwise -------------

def _card_calls():
    from indigo_tpu_torch.models import (cartesian_sense_op, centered_fft_op,
                                         nufft_op, sense_nufft_op)
    from indigo_tpu_torch.noncart import pipe_menon_dcf
    from indigo_tpu_torch.ops.tile_interp import plan_tile_interp
    from indigo_tpu_torch.parallel import sense_batch_recon
    from indigo_tpu_torch.toeplitz import toeplitz_kernel
    rng = np.random.default_rng(0)
    traj = np.linspace(-0.4, 0.4, 40)[:, None] * np.ones((1, 2))
    maps = np.ones((2, 8, 8), np.complex64)
    b = np.ones(6, np.complex64)
    plan = plan_tile_interp(rng.uniform(-0.5, 0.5, (30, 2)), (16, 16),
                            width=4, beta=6.5)
    Tf = rng.standard_normal((16, 16, 16))       # 64-bit, as a user's
    maps3 = rng.standard_normal((2, 8, 8, 8)) + 0j
    traj3 = rng.uniform(-0.5, 0.5, (50, 3))
    return {
        "cartesian_sense_op": lambda **k: cartesian_sense_op(
            np.ones((8, 8), bool), maps, **k),
        "centered_fft_op": lambda **k: centered_fft_op((8, 8), **k),
        "nufft_op": lambda **k: nufft_op(traj, (8, 8), **k)[0],
        "sense_nufft_op": lambda **k: sense_nufft_op(traj, maps, **k)[0],
        "DWT": lambda **k: tit.DWT((8, 8), "haar", levels=1, **k),
        "cg": lambda **k: tit.cg(lambda v: 2.0 * v, b, maxiter=2, **k)[0],
        "apgd": lambda **k: tit.apgd(lambda v: 2.0 * v, lambda v, a: v, 0.5,
                                     b, maxiter=2, **k)[0],
        "max_eigen": lambda **k: tit.max_eigen(lambda v: 2.0 * v, 6, iters=2,
                                               **k),
        # the eight leaves that hold arrays, from host data
        "SpMatrix": lambda **k: tit.SpMatrix(randM(6, 5, 0.5, rng=0), **k),
        "KBInterp": lambda **k: tit.KBInterp(plan, **k),
        "DenseMatrix": lambda **k: tit.DenseMatrix(np.eye(3), **k),
        "Diag": lambda **k: tit.Diag(np.ones(3), **k),
        "CenteredDFT": lambda **k: tit.CenteredDFT((8, 8), (16, 16), **k),
        "GridDFT": lambda **k: tit.GridDFT(plan, (8, 8), **k),
        "Perm": lambda **k: tit.Perm([2, 0, 1], **k),
        "Mask": lambda **k: tit.Mask([0, 2], 4, **k),
        # a tree without arrays times a numpy operand
        "array-less tree * ndarray": lambda **k: (
            tit.Eye(6, **k) * tit.UnscaledFFT((2, 3), **k)
            * tit.CropPad((2, 2), (2, 3), **k)) * np.ones(4),
        "ToeplitzNormal": lambda **k: tit.ToeplitzNormal(Tf, (8, 8, 8), **k),
        "sense_normal_toeplitz": lambda **k: tit.sense_normal_toeplitz(
            Tf, maps3, **k),
        # host results: the doubled and the padded grid are 64^3 and over
        "toeplitz_kernel": lambda **k: toeplitz_kernel(
            traj3, (24, 24, 24), width=4, warn=False, **k),
        "pipe_menon_dcf": lambda **k: pipe_menon_dcf(
            traj3, (64, 64, 64), width=4, iters=2, **k),
        "sense_batch_recon": lambda **k: sense_batch_recon(
            Tf, maps3, rng.standard_normal((1, 512)), iters=2, **k)[0],
        "soft_thresh": lambda **k: tit.soft_thresh(np.ones(4), 0.1, **k),
    }


@pytest.mark.parametrize("name", [
    "cartesian_sense_op", "centered_fft_op", "nufft_op", "sense_nufft_op",
    "DWT", "cg", "apgd", "max_eigen", "SpMatrix", "KBInterp", "DenseMatrix",
    "Diag", "CenteredDFT", "GridDFT", "Perm", "Mask",
    "array-less tree * ndarray", "ToeplitzNormal", "sense_normal_toeplitz",
    "toeplitz_kernel", "pipe_menon_dcf", "sense_batch_recon", "soft_thresh"])
def test_entry_point_defaults_to_the_card(name):
    """Handed host data and no ``device``, an entry point goes to the card:
    where there is none it raises and does not quietly stay on the host;
    ``device="cpu"`` is how a caller asks for the host. (The DCF and the
    spectrum return numpy on either; their host run is the one that needs
    no card.)"""
    call = _card_calls()[name]
    out = call(device="cpu")
    if isinstance(out, np.ndarray):
        assert out.dtype == np.float32
    else:
        dev = out.device
        assert dev is not None and dev.type == "cpu"
        if isinstance(out, tit.Operator):
            assert all(t.device.type == "cpu" for t in out.buffers())
    if torch.cuda.is_available():
        out = call()
        assert isinstance(out, np.ndarray) or out.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def _two_device_calls():
    """Calls whose tensors lie on two devices (the CPU and torch's "meta"
    device, which stands in for the card here), with no ``device=``."""
    from indigo_tpu_torch.parallel import sense_batch_recon
    from indigo_tpu_torch.parallel.recon import sense_normal_batched
    rng = np.random.default_rng(0)
    img = (8, 8, 8)
    Tf = rng.standard_normal((16, 16, 16)).astype(np.float32)
    maps = torch.from_numpy(rand64c(2, *img, rng=rng))
    x = torch.from_numpy(rand64c(1, 512, rng=rng))
    meta = torch.device("meta")
    return {
        "Operator * tensor": lambda: tit.Diag(np.ones(3), device=meta)
        * torch.ones(3, dtype=torch.complex64),
        "Operator.eval": lambda: tit.Diag(np.ones(3), device=meta).eval(
            torch.ones(3, dtype=torch.complex64)),
        "cg": lambda: tit.cg(tit.Diag(np.ones(3), device=meta),
                             torch.ones(3, dtype=torch.complex64),
                             maxiter=2),
        "sense_normal_batched": lambda: sense_normal_batched(
            Tf, maps, x.to(meta)),
        "sense_batch_recon": lambda: sense_batch_recon(
            Tf, maps.to(meta), x, iters=2),
        "sense_normal_toeplitz": lambda: tit.sense_normal_toeplitz(
            torch.from_numpy(Tf), maps.to(meta)),
    }


@pytest.mark.parametrize("name", [
    "Operator * tensor", "Operator.eval", "cg", "sense_normal_batched",
    "sense_batch_recon", "sense_normal_toeplitz"])
def test_entry_point_leaves_tensors_where_they_are(name):
    """A tensor is never moved to another device on its own: tensors on
    two devices raise, so a card tensor never runs on the host because an
    operator or another input lies there."""
    with pytest.raises((RuntimeError, ValueError)):
        _two_device_calls()[name]()


def test_host_data_joins_the_tensors_device():
    """With no ``device=``, host data goes where the tensors given lie, and
    needs no card when they lie on the host."""
    from indigo_tpu_torch.parallel.recon import sense_normal_batched
    rng = np.random.default_rng(1)
    Tf = rng.standard_normal((16, 16, 16))                    # float64
    maps = torch.from_numpy(rand64c(2, 8, 8, 8, rng=rng))
    x = rand64c(1, 512, rng=rng).astype(np.complex128)
    out = sense_normal_batched(Tf, maps, x)
    want = sense_normal_batched(Tf, maps, x, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.complex64
    assert torch.equal(out, want)
    N = tit.sense_normal_toeplitz(torch.from_numpy(Tf.astype(np.float32)),
                                  maps)
    assert all(t.device.type == "cpu" for t in N.buffers())
