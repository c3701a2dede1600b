"""Start the ranks of a process group on this host and run a function on
every one of them.

The reference is one process that sees all its devices; ``torch.distributed``
is one process per device. ``launch`` is the single-host way to get them:

    from indigo_tpu_torch.parallel.launch import launch
    out = launch(fn, nprocs=4, args=(Tf, maps, rhs))      # fn(*args) per rank

where ``fn`` is a picklable (module-level) function that calls
``make_mesh`` and the sharded entry points; ``launch`` returns what rank 0
returned. Under ``torchrun`` (several cards or hosts) none of this is
needed: initialise the group there and ``make_mesh`` uses it.

The ranks are started with the ``spawn`` method (CUDA and ``fork`` do not
mix) and meet through a file store in a fresh temporary directory, so
concurrent launches on one host never share a port. ``device="cuda"`` (the
default) gives rank r the card ``r`` modulo the number of cards, over NCCL
where every rank has a card of its own and over gloo where ranks share one;
a rank that finds no CUDA raises. ``device="cpu"`` runs gloo ranks of one
thread each. A rank that raises, dies or outlives ``timeout`` ends the
launch: the remaining ranks are killed and ``launch`` raises.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["launch"]


def _rank_main(fn, args, rank, nprocs, device, store, timeout, results):
    try:
        # all ranks are on this host: gloo meets over the loopback interface
        # (it otherwise resolves the host's name, which a sealed machine may
        # not be able to)
        if os.path.exists("/sys/class/net/lo"):
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "launch(device='cuda'): this rank finds no CUDA device")
            ncards = torch.cuda.device_count()
            torch.cuda.set_device(rank % ncards)
            backend = "nccl" if nprocs <= ncards else "gloo"
        else:
            torch.set_num_threads(1)
            backend = "gloo"
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=nprocs, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:  # report, then let the parent end the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, nprocs, args=(), device="cuda", timeout=300.0):
    """Run ``fn(*args)`` on ``nprocs`` ranks of a new process group on this
    host; returns rank 0's return value (pickled back, so keep it numpy or
    plain Python). ``timeout`` (seconds) bounds the whole launch and every
    collective in it."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"launch: device must be 'cuda' or 'cpu', not "
                         f"{device!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="indigo_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, args, rank, nprocs, device, store, timeout, results))
            for rank in range(nprocs)]
        try:
            for p in procs:
                p.start()
            done, out = set(), None
            while len(done) < nprocs:
                try:
                    rank, ok, payload = results.get(timeout=0.2)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"launch: ranks {sorted(set(range(nprocs)) - done)}"
                            f" did not finish within {timeout} s") from None
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    # a rank that reported puts its result before it exits;
                    # look once more before calling it lost
                    if dead and results.empty():
                        time.sleep(0.5)
                        if results.empty():
                            raise RuntimeError(
                                f"launch: rank {dead[0]} exited with code "
                                f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"launch: rank {rank} failed:\n"
                                       f"{payload}")
                done.add(rank)
                if rank == 0:
                    out = payload
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(10)
