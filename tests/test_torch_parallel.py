"""The port's sharded paths on 8 gloo ranks (CPU) against the reference on
its virtual 8-device mesh, from the same numpy inputs.

The reference is one process that sees eight devices; the port is one
process per device. Each test starts the ranks once
(``parallel.launch.launch``, ``device="cpu"``), lets every rank run several
entry points on the same global arrays, and gets rank 0's results back as
numpy; the reference's answers are computed in this process.

The rank functions live at module level here because the ranks are spawned
and import this module: its top level therefore imports no jax (the tests
import it inside), so a rank never starts it.

Tolerances are those of tests/test_parallel.py: 1e-5 for the FFTs and for
slab against pencil, 1e-4 for the CG solves (rounding differences grow
over the iterations), 1e-6 / 1e-5 for the per-slice independence check.
"""
import numpy as np
import pytest
import torch

from indigo_tpu_torch.parallel import (
    batched_cg, fftn_sharded, fftn_sharded2, make_mesh, replicated,
    sense_batch_recon, sense_normal_volsharded, sense_vol_recon,
    sense_vol_recon2, shard_along)
from indigo_tpu_torch.parallel import collectives as C
from indigo_tpu_torch.parallel.launch import launch
from indigo_tpu_torch.parallel.mesh import Placement
from indigo_tpu_torch.utils import rand64c, rel_err

NRANKS = 8
TIMEOUT = 480.0


def run(fn, *args, nprocs=NRANKS):
    return launch(fn, nprocs, args=args, device="cpu", timeout=TIMEOUT)


def host(t):
    return t.detach().cpu().numpy()


def raises(exc, fn, *args, **kw):
    """True if fn raises exc (a rank cannot use pytest.raises' report)."""
    try:
        fn(*args, **kw)
    except exc:
        return True
    return False


# ---- mesh ------------------------------------------------------------------

def ranks_mesh():
    mesh = make_mesh(device="cpu", slice=4, coil=2)
    rest = make_mesh(device="cpu", slice=-1, coil=2)
    small = make_mesh(device="cpu", a=2, b=2)        # 4 of the 8 ranks
    # every rank's coordinates, gathered: (8, 2)
    coords = C.gather_blocks(torch.tensor(
        [mesh.coords["slice"], mesh.coords["coil"]]), mesh, mesh.group())
    # the members of this rank's group along each axis
    me = torch.tensor([mesh.rank])
    along = {ax: host(C.gather_blocks(me, mesh, mesh.group(ax))).ravel()
             for ax in ("slice", "coil")}
    place = shard_along(mesh, "coil", 3, dim=1)
    x = np.arange(2 * 4 * 3).reshape(2, 4, 3)
    out = _mesh_readings(mesh, rest, small, coords, along, place, x)
    # one Mesh per layout: asking again creates no groups; close() frees
    # them, and the layout can be built anew
    import torch.distributed as dist
    groups = dist.distributed_c10d._world.group_count
    out["cached"] = (make_mesh(device="cpu", slice=4, coil=2) is mesh
                     and rest is mesh
                     and make_mesh(device="cpu", coil=2, slice=4) is not mesh
                     and dist.distributed_c10d._world.group_count
                     == groups + 4 + 2)       # the (coil, slice) mesh's lines
    live = len(dist.distributed_c10d._world.pg_map)
    mesh.close()
    out["freed"] = live - len(dist.distributed_c10d._world.pg_map)
    out["closed"] = raises(RuntimeError, C.psum, me, mesh, "coil")
    mesh.close()                                      # closing twice is fine
    anew = make_mesh(device="cpu", slice=4, coil=2)
    out["anew"] = anew is not mesh and int(C.psum(
        torch.ones(1), anew, ("slice", "coil"))) == 8
    return out


def _mesh_readings(mesh, rest, small, coords, along, place, x):
    return {
        "shape": mesh.shape, "rest": rest.shape, "ranks": mesh.ranks,
        "coords": host(coords), "along": along,
        "device": str(mesh.device),
        "too_many": raises(ValueError, make_mesh, device="cpu", slice=8,
                           coil=2),
        "small_member": small.member, "small_shape": small.shape,
        "spec": place.spec, "replicated": replicated(mesh).spec,
        "local": host(place.local(x)),
        "gathered": host(place.gather(place.local(x))),
        "whole": host(replicated(mesh).local(x)),
        "indivisible": raises(ValueError,
                              shard_along(mesh, "slice", 1).local,
                              np.zeros(6)),
        "no_axis": raises(ValueError, Placement, mesh, ("vol",)),
    }


@pytest.fixture(scope="module")
def mesh_run():
    return run(ranks_mesh)


def test_make_mesh_shapes_and_rank_layout(mesh_run):
    import jax
    from indigo_tpu.parallel import make_mesh as j_make_mesh

    out = mesh_run
    jm = j_make_mesh(slice=4, coil=2)
    assert out["shape"] == dict(jm.shape) == {"slice": 4, "coil": 2}
    assert out["rest"]["slice"] == j_make_mesh(slice=-1, coil=2).shape[
        "slice"] == 4
    assert out["too_many"] and out["device"] == "cpu"
    with pytest.raises(ValueError):
        j_make_mesh(slice=8, coil=2)
    # rank r sits where the reference puts device r
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    first = jax.devices()[0].id
    np.testing.assert_array_equal(out["ranks"], ids - first)
    for r in range(NRANKS):
        assert tuple(out["coords"][r]) == tuple(
            int(c[0]) for c in np.where(out["ranks"] == r))
    # rank 0's groups: the ranks that differ from it in one coordinate only
    np.testing.assert_array_equal(out["along"]["slice"], out["ranks"][:, 0])
    np.testing.assert_array_equal(out["along"]["coil"], out["ranks"][0, :])
    # a mesh smaller than the world leaves the other ranks outside
    assert out["small_member"] and out["small_shape"] == {"a": 2, "b": 2}


def test_placements_cut_and_assemble(mesh_run):
    out = mesh_run
    x = np.arange(24).reshape(2, 4, 3)
    assert out["spec"] == (None, "coil", None) and out["replicated"] == ()
    np.testing.assert_array_equal(out["local"], x[:, :2])      # rank 0
    np.testing.assert_array_equal(out["gathered"], x)
    np.testing.assert_array_equal(out["whole"], x)
    assert out["indivisible"] and out["no_axis"]


def test_make_mesh_is_cached_and_close_frees_its_groups(mesh_run):
    out = mesh_run
    assert out["cached"]
    assert out["freed"] == 2          # this rank's 'slice' and 'coil' lines
    assert out["closed"] and out["anew"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu", x=1)


# ---- collectives -----------------------------------------------------------

def _rank_array(seed, r, shape):
    return rand64c(*shape, rng=np.random.default_rng(1000 * seed + r))


def ranks_collectives(seed):
    """Every collective against its definition, checked on EVERY rank (each
    rank can rebuild all ranks' inputs from the seed); a mismatch raises."""
    mesh = make_mesh(device="cpu", a=4, b=2)
    one = make_mesh(device="cpu", a=1, b=8)
    ia, ib = mesh.coords["a"], mesh.coords["b"]
    shape = (8, 3, 4)
    mine = torch.from_numpy(_rank_array(seed, mesh.rank, shape))
    every = np.stack([_rank_array(seed, r, shape) for r in range(NRANKS)]
                     ).reshape((4, 2) + shape)         # [a, b] -> array

    def same(got, want, exact=False):
        got = host(got)
        assert got.shape == want.shape, (got.shape, want.shape)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert rel_err(got, want) < 1e-6

    # all_to_all over 'a' (tiled): block ia of every rank's dim 0, in rank
    # order along dim 2; complex64 as it is; a non-contiguous input
    want = np.concatenate([every[j, ib][2 * ia:2 * ia + 2] for j in range(4)],
                          axis=2)
    same(C.all_to_all(mine, mesh, "a", split_axis=0, concat_axis=2), want,
         exact=True)
    t = mine.permute(2, 1, 0)                          # (4, 3, 8) view
    want_t = np.concatenate(
        [every[ia, j].transpose(2, 1, 0)[2 * ib:2 * ib + 2] for j in range(2)],
        axis=0)
    same(C.all_to_all(t, mesh, "b", split_axis=0, concat_axis=0), want_t,
         exact=True)
    # psum over one axis, over both (a tuple), and over the other
    same(C.psum(mine, mesh, "a"), every[:, ib].sum(0))
    same(C.psum(mine, mesh, ("a", "b")), every.sum((0, 1)))
    same(C.psum(mine, mesh, ("b",)), every[ia].sum(0))
    # the same bits on every rank of the group
    s = C.psum(mine, mesh, ("a", "b"))
    allsum = C.gather_blocks(s, mesh, mesh.group())
    assert bool((allsum == s[None]).all())
    # psum_scatter (tiled) over 'a' along dim 0
    same(C.psum_scatter(mine, mesh, "a", scatter_dimension=0),
         every[:, ib].sum(0)[2 * ia:2 * ia + 2])
    same(C.psum_scatter(mine, mesh, "b", scatter_dimension=2),
         every[ia].sum(0)[:, :, 2 * ib:2 * ib + 2])
    # all_gather along a dim
    same(C.all_gather(mine, mesh, "b", 1),
         np.concatenate([every[ia, j] for j in range(2)], axis=1), exact=True)
    # an axis of size 1 is a no-op that copies nothing
    for out in (C.all_to_all(mine, one, "a", 0, 2), C.psum(mine, one, "a"),
                C.psum_scatter(mine, one, "a", 0),
                C.all_gather(mine, one, "a", 0)):
        assert out is mine
    # what does not divide raises
    assert raises(ValueError, C.all_to_all, mine, mesh, "a", 1, 0)
    assert raises(ValueError, C.psum_scatter, mine, mesh, "a", 1)
    return {"transport": C.transport(mesh), "calls": mesh.stats["calls"],
            "bytes": mesh.stats["bytes_sent"],
            "seconds": mesh.stats["seconds"]}


def test_collectives_match_their_definitions():
    out = run(ranks_collectives, 3)
    assert out["transport"] == "gloo"
    assert out["calls"] > 0 and out["bytes"] > 0
    assert out["seconds"] > 0         # gloo is synchronous: timed, not None


# ---- distributed FFT ---------------------------------------------------------

def ranks_fft(v3, v4):
    slab = make_mesh(device="cpu", x=8)
    pencil = make_mesh(device="cpu", x=4, y=2)
    return {
        "slab": host(fftn_sharded(v3, slab, axis_name="x")),
        "slab_inv": host(fftn_sharded(v3, slab, axis_name="x",
                                      inverse=True)),
        "slab_tensor": host(fftn_sharded(torch.from_numpy(v3), slab)),
        "pencil": host(fftn_sharded2(v4, pencil, axes=("x", "y"))),
        "pencil_inv": host(fftn_sharded2(v4, pencil, axes=("x", "y"),
                                         inverse=True)),
        "slab_indivisible": raises(ValueError, fftn_sharded, v3[:, :6], slab),
        "pencil_indivisible": raises(ValueError, fftn_sharded2, v4[:, :, :3],
                                     pencil),
        "pencil_2d": raises(ValueError, fftn_sharded2, v3[:, :, 0], pencil),
    }


def test_fftn_sharded_slab_and_pencil(rng):
    import indigo_tpu as it
    from indigo_tpu.parallel import fftn_sharded as j_fft
    from indigo_tpu.parallel import fftn_sharded2 as j_fft2
    from indigo_tpu.parallel import make_mesh as j_make_mesh

    v3 = rand64c(16, 8, 4, rng=rng)
    v4 = rand64c(8, 8, 4, 3, rng=rng)
    out = run(ranks_fft, v3, v4)
    slab, pencil = j_make_mesh(x=8), j_make_mesh(x=4, y=2)
    cases = {
        "slab": (np.fft.fftn(v3), lambda v: j_fft(v, slab, "x"), v3),
        "slab_inv": (np.fft.ifftn(v3),
                     lambda v: j_fft(v, slab, "x", inverse=True), v3),
        "pencil": (np.fft.fftn(v4), lambda v: j_fft2(v, pencil), v4),
        "pencil_inv": (np.fft.ifftn(v4),
                       lambda v: j_fft2(v, pencil, inverse=True), v4),
    }
    for key, (want, jfn, v) in cases.items():
        assert rel_err(out[key], want) < 1e-5, key
        assert rel_err(out[key], np.asarray(it.cplx.cjit(jfn)(v))) < 1e-5, key
    assert rel_err(out["slab_tensor"], np.fft.fftn(v3)) < 1e-5
    assert out["slab_indivisible"] and out["pencil_indivisible"] \
        and out["pencil_2d"]


# ---- slices x coils ------------------------------------------------------------

def ranks_batch(Tf, maps, xs):
    mesh = make_mesh(device="cpu", slice=4, coil=2)
    kw = dict(lamda=1.0, iters=15)
    x, res = sense_batch_recon(Tf, maps, xs, mesh=mesh, **kw)
    x0, res0 = sense_batch_recon(Tf, maps, xs, mesh=None, device="cpu", **kw)
    xc, _ = sense_batch_recon(Tf, maps, xs, mesh=mesh, coil_chunk=1, **kw)
    # tensors go in as numpy does
    xt, _ = sense_batch_recon(torch.from_numpy(Tf), torch.from_numpy(maps),
                              torch.from_numpy(xs), mesh=mesh, **kw)
    # per-slice systems: scaling slice 0's rhs leaves slice 1 alone
    xs2 = xs.copy()
    xs2[0] *= 3.0
    x2, _ = sense_batch_recon(Tf, maps, xs2, mesh=mesh, lamda=1.0, iters=10)
    x1, _ = sense_batch_recon(Tf, maps, xs, mesh=mesh, lamda=1.0, iters=10)
    return {"x": host(x), "res": host(res), "x0": host(x0),
            "res0": host(res0), "x_chunk": host(xc), "x_tensor": host(xt),
            "x1": host(x1), "x2": host(x2),
            "odd_slices": raises(ValueError, sense_batch_recon, Tf, maps,
                                 xs[:6], mesh=mesh)}


def _batch_problem(rng, S=8, nc=4, n=12):
    from indigo_tpu.toeplitz import toeplitz_kernel

    traj = rng.random((60, 2)) - 0.5
    maps = rand64c(nc, n, n, rng=rng)
    Tf = np.asarray(toeplitz_kernel(traj, (n, n), oversamp=2.0, width=6))
    return Tf, maps, rand64c(S, n * n, rng=rng)


@pytest.fixture(scope="module")
def batch_run():
    Tf, maps, xs = _batch_problem(np.random.default_rng(1234))
    return (Tf, maps, xs), run(ranks_batch, Tf, maps, xs)


@pytest.mark.parametrize("coil_chunk", [None, 1])
def test_sense_batch_recon_mesh_matches_reference(batch_run, coil_chunk):
    from indigo_tpu.parallel import make_mesh as j_make_mesh
    from indigo_tpu.parallel import sense_batch_recon as j_recon

    (Tf, maps, xs), out = batch_run
    xr, rr = j_recon(Tf, maps, xs, mesh=j_make_mesh(slice=4, coil=2),
                     lamda=1.0, iters=15, coil_chunk=coil_chunk)
    x = out["x"] if coil_chunk is None else out["x_chunk"]
    assert x.shape == (8, 144) and out["res"].shape == (15, 8)
    assert rel_err(x, np.asarray(xr)) < 1e-4
    assert rel_err(out["res"], np.asarray(rr)) < 1e-4


def test_sense_batch_recon_mesh_matches_one_device(batch_run):
    _, out = batch_run
    assert rel_err(out["x"], out["x0"]) < 1e-4
    assert rel_err(out["res"], out["res0"]) < 1e-4
    assert rel_err(out["x_chunk"], out["x"]) < 1e-5
    assert rel_err(out["x_tensor"], out["x"]) < 1e-6
    assert out["odd_slices"]


def test_sense_batch_recon_mesh_per_slice_convergence(batch_run):
    _, out = batch_run
    assert rel_err(out["x2"][1], out["x1"][1]) < 1e-6
    assert rel_err(out["x2"][0], 3 * out["x1"][0]) < 1e-5


# ---- one volume in slabs and pencils -----------------------------------------

def _dense_system(seed, n, S):
    rng = np.random.default_rng(seed)
    M = rand64c(n, n, rng=rng)
    A = (M @ M.conj().T + 5 * np.eye(n)).astype(np.complex64)
    rhs = rand64c(S, n, rng=rng)
    rhs[1] *= 1e-3
    return A, rhs


def ranks_volume(Tf, maps, rhs, lam, Tf8, maps8, rhs8, lam8):
    slab = make_mesh(device="cpu", vol=8)
    pencil = make_mesh(device="cpu", vz=4, vy=2)
    out = {}
    # one apply of the slab normal op on this rank's blocks, assembled
    vol = Placement(slab, ("vol",))
    blocks = Placement(slab, (None, "vol"))
    Nv = sense_normal_volsharded(
        blocks.local(Tf, torch.float32), blocks.local(maps),
        vol.local(rhs), "vol", mesh=slab)
    out["apply"] = host(vol.gather(Nv))
    x, res = sense_vol_recon(Tf, maps, rhs, slab, axis_name="vol", lamda=lam,
                             iters=12)
    out["x"], out["res"] = host(x), host(res)
    x0, _ = sense_batch_recon(Tf, maps, rhs.reshape(1, -1), lamda=lam,
                              iters=12, device="cpu")
    out["x0"] = host(x0)[0]
    # the 8^3 volume both decompositions take
    xs, rs = sense_vol_recon(Tf8, maps8, rhs8, slab, lamda=lam8, iters=6)
    xp, rp = sense_vol_recon2(Tf8, maps8, rhs8, pencil, lamda=lam8, iters=6)
    x80, _ = sense_batch_recon(Tf8, maps8, rhs8.reshape(1, -1), lamda=lam8,
                               iters=6, device="cpu")
    out.update(x8_slab=host(xs), x8_pencil=host(xp), res8=host(rp),
               x8_one=host(x80)[0])
    # what the meshes do not divide is rejected up front
    bad = rand64c(2, 6, 8, 8, rng=np.random.default_rng(0))
    out["errors"] = [
        raises(ValueError, sense_vol_recon2, Tf8, bad, bad[0], pencil),
        raises(ValueError, sense_vol_recon, Tf8, bad, bad[0], slab),
        raises(ValueError, sense_vol_recon, Tf8, maps8[:, 0], rhs8[0], slab),
        raises(ValueError, sense_vol_recon2, Tf8, maps8[:, 0], rhs8[0],
               pencil),
        raises(ValueError, batched_cg, lambda v: v, torch.zeros(1, 4),
               psum_axis="vol"),
    ]
    # tol > 0 with the feature dimension sharded: the psum'd scalars are
    # the same bits on every rank, so every rank freezes at the same step
    A, b = _dense_system(7, 48, 3)
    cols = Placement(slab, (None, "vol"))
    A_l = cols.local(A.T.copy()).T            # this rank's rows of A
    b_l = cols.local(b)

    def mv(v_l):                              # (S, n/p) -> (S, n/p)
        v = C.all_gather(v_l, slab, "vol", 1)
        return v @ A_l.T

    xk, resk, k = batched_cg(mv, b_l, iters=150, tol=1e-8, psum_axis="vol",
                             return_iters=True, mesh=slab)
    out["k_all"] = host(C.gather_blocks(k, slab, slab.group()))
    out["xk"] = host(cols.gather(xk))
    out["resk"] = host(resk)
    return out


def _volume_problem(rng, img, nc, nsamp, width):
    from indigo_tpu.toeplitz import toeplitz_kernel

    traj = rng.random((nsamp, 3)) - 0.5
    maps = rand64c(nc, *img, rng=rng)
    # accurate kernel + meaningful lamda, as tests/test_parallel.py
    Tf = np.asarray(toeplitz_kernel(traj, img, oversamp=2.0, width=width))
    return Tf, maps, rand64c(*img, rng=rng), 0.05 * float(np.abs(Tf).max())


@pytest.fixture(scope="module")
def volume_run():
    rng = np.random.default_rng(1234)
    big = _volume_problem(rng, (16, 16, 16), 2, 200, 6)
    small = _volume_problem(rng, (8, 8, 8), 2, 120, 4)
    return big, small, run(ranks_volume, *big, *small)


def test_volume_sharded_normal_apply(volume_run):
    import jax.numpy as jnp
    from indigo_tpu.parallel import sense_normal_batched as j_batched

    (Tf, maps, rhs, _), _, out = volume_run
    ref = np.asarray(j_batched(jnp.asarray(Tf), maps, rhs.reshape(1, -1)))
    assert rel_err(out["apply"].ravel(), ref[0]) < 1e-5


def test_sense_vol_recon_matches_reference(volume_run):
    from indigo_tpu.parallel import make_mesh as j_make_mesh
    from indigo_tpu.parallel import sense_vol_recon as j_vol

    (Tf, maps, rhs, lam), _, out = volume_run
    xr, rr = j_vol(Tf, maps, rhs, j_make_mesh(vol=8), axis_name="vol",
                   lamda=lam, iters=12)
    assert out["x"].shape == (16, 16, 16) and out["res"].shape == (12,)
    assert rel_err(out["x"], np.asarray(xr)) < 1e-4
    assert rel_err(out["res"], np.asarray(rr)) < 1e-4
    assert rel_err(out["x"].ravel(), out["x0"]) < 1e-4


def test_sense_vol_recon2_matches_reference_and_slab(volume_run):
    from indigo_tpu.parallel import make_mesh as j_make_mesh
    from indigo_tpu.parallel import sense_vol_recon2 as j_vol2

    _, (Tf, maps, rhs, lam), out = volume_run
    xr, _ = j_vol2(Tf, maps, rhs, j_make_mesh(vz=4, vy=2), lamda=lam,
                   iters=6)
    assert out["res8"].shape == (6,)
    assert rel_err(out["x8_pencil"], np.asarray(xr)) < 1e-4
    assert rel_err(out["x8_pencil"].ravel(), out["x8_one"]) < 1e-5
    assert rel_err(out["x8_slab"], out["x8_pencil"]) < 1e-5


def test_volume_solvers_reject_what_the_mesh_does_not_divide(volume_run):
    assert all(volume_run[2]["errors"])


def test_batched_cg_psum_axis_tol_same_count_on_every_rank(volume_run):
    out = volume_run[2]
    A, b = _dense_system(7, 48, 3)
    k = out["k_all"]
    assert k.shape == (NRANKS, 3)
    assert (k == k[0]).all()                 # every rank froze together
    assert (k[0] < 150).all() and (k[0] > 3).all()
    xd = np.linalg.solve(A.astype(np.complex128),
                         b.T.astype(np.complex128)).T
    assert rel_err(out["xk"], xd) < 1e-4
    for s in range(3):                       # frozen after convergence
        tail = out["resk"][k[0][s]:, s]
        assert np.allclose(tail, tail[0])


# ---- the launcher ---------------------------------------------------------------

def rank_fails(which):
    import time
    mesh = make_mesh(device="cpu", x=2)
    if mesh.rank == which:
        raise KeyError("this rank fails")
    # the other rank then waits in a collective that never completes
    time.sleep(3)
    return host(C.psum(torch.ones(1), mesh, "x"))


def rank_hangs():
    import time
    mesh = make_mesh(device="cpu", x=2)
    if mesh.rank == 1:
        time.sleep(600)
    return 1


def rank_threads():
    return torch.get_num_threads(), torch.distributed.get_backend()


def test_launch_raises_when_a_rank_fails():
    import time
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*KeyError"):
        launch(rank_fails, 2, args=(1,), device="cpu", timeout=120.0)
    assert time.time() - t0 < 60


def test_launch_kills_ranks_after_its_timeout():
    import time
    t0 = time.time()
    with pytest.raises(TimeoutError):
        launch(rank_hangs, 2, device="cpu", timeout=10.0)
    assert time.time() - t0 < 60


def test_launch_cpu_ranks_are_single_threaded_gloo():
    assert launch(rank_threads, 1, device="cpu", timeout=60.0) == (1, "gloo")
    with pytest.raises(ValueError):
        launch(rank_threads, 1, device="tpu")


def test_launcher_and_mesh_default_to_the_card(tmp_path):
    """With no ``device`` the ranks and the mesh go to the card; where there
    is none they raise and do not quietly stay on the host."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        assert launch(rank_threads, 1, timeout=120.0)[1] == "nccl"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch(rank_threads, 1, timeout=120.0)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        if torch.cuda.is_available():
            assert make_mesh(x=1).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_mesh(x=1)
        mesh = make_mesh(device="cpu", x=1)
        assert mesh.device.type == "cpu" and mesh.group("x") is None
        with pytest.raises(ValueError):
            mesh.group("y")
    finally:
        dist.destroy_process_group()
