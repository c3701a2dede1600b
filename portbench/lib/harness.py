"""One run of one cell: set-up, the measured window, the traced stretch,
the per-layer readers, the correctness check against the plain reference,
and the result line.

The window is driven as the cell's mix says: its entry (``entries/<e>.py``:
what is called per request, and how), the dtype its client hands the
k-space over in, and its loop: closed, where each of ``clients`` sends its
next request when its previous image is on the host, or open, with arrivals
at ``rate_per_s`` drawn from the seed. The program serves the requests in
the order they are handed. Requests are handed while the window's seconds
have not run out; the window closes when the last of them has come back, so
a rate is taken over all the work and all the time of the window.
"""
from __future__ import annotations

import gc
import sys
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from portbench.lib import spec, tracing

# top-level module names that must not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "indigo_tpu")
# the compared number of an output that is not finite: larger than any
# limit, and still a number in the result line's JSON
NOT_FINITE = 1e308


def log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def request_order(pool, seed):
    """Pool indices for the window: the pool in a seeded order, again and
    again, each pass a new permutation."""
    rng = np.random.default_rng([seed, 0])
    while True:
        yield from (int(i) for i in rng.permutation(pool))


class Sample:
    """A uniform sample, drawn from the seed, of the window's outputs
    (reservoir sampling: the window's length is not known ahead)."""

    def __init__(self, size, seed):
        self.size, self.rng, self.seen, self.kept = size, \
            np.random.default_rng([seed, 1]), 0, []

    def offer(self, index, output):
        if len(self.kept) < self.size:
            self.kept.append((index, output))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = (index, output)
        self.seen += 1


def arrivals(mix, seed):
    """Offsets in seconds from the window's start at which requests are
    handed over: an open loop's Poisson arrivals at ``rate_per_s`` drawn
    from the seed, or None for a closed loop."""
    if mix["loop"] == "closed":
        return None
    if mix["loop"] != "open":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    rng = np.random.default_rng([seed, 3])
    scale = 1.0 / float(mix["rate_per_s"])

    def offsets():
        t = 0.0
        while True:
            t += float(rng.exponential(scale))
            yield t
    return offsets()


def window(kind, fn, pool, mix, seed, seconds, sample, stretch=None):
    """Drive ``fn`` for ``seconds`` under the mix's loop. Returns (records,
    window_s, attempted, failed), with one (pool index, handed, done)
    record per request that came back; a request is handed when its client
    sends it (closed loop) or at its arrival (open loop), so its latency
    counts the time it waits in the queue."""
    order = request_order(len(pool), seed)
    arrive = arrivals(mix, seed)
    clients = int(mix["clients"]) if arrive is None else None
    clock = time.perf_counter
    queue, records = deque(), []
    state = {"handed": 0, "started": 0, "next": None}
    t0 = clock()

    def more(at):
        # a traced run goes on until its stretch is whole: starting the
        # profiler takes seconds of the window, and a traced run reports
        # no end-to-end metric
        return at - t0 < seconds or (
            stretch is not None
            and state["handed"] <= stretch.skip + stretch.count)

    def hand(at):
        queue.append((next(order), at))
        state["handed"] += 1

    def admit(now):
        """Hand what has arrived by ``now``; True while more will."""
        if arrive is None:
            while state["handed"] - len(records) < clients and more(now):
                hand(now)
            return False
        while True:
            if state["next"] is None:
                state["next"] = t0 + next(arrive)
            if not more(state["next"]):
                return False
            if state["next"] > now:
                return True
            hand(state["next"])
            state["next"] = None

    def start():
        if stretch is not None:
            stretch.before(state["started"])
        state["started"] += 1

    if kind == "call":
        while True:
            waiting = admit(clock())
            if not queue:
                if not waiting:
                    break
                time.sleep(max(0.0, state["next"] - clock()))
                continue
            i, th = queue.popleft()
            start()
            try:
                out = fn(pool[i])
            except Exception as e:  # a request that fails is counted
                log(f"request {state['started'] - 1} failed: {e!r}")
                records.append((i, th, None))
                continue
            records.append((i, th, clock()))
            sample.offer(i, out)
    elif kind == "stream":
        if arrive is None and clients != 1:
            raise ValueError("a stream is fed by one client")
        pulled = []

        def inputs():
            while True:
                now = clock()
                if arrive is None:
                    # the one client hands the next request when the
                    # stream asks for it
                    if not more(now):
                        return
                    hand(now)
                elif not admit(now) and not queue:
                    return
                elif not queue:
                    time.sleep(max(0.0, state["next"] - clock()))
                    continue
                i, th = queue.popleft()
                start()
                pulled.append((i, th))
                yield pool[i]
        try:
            for k, out in enumerate(fn(inputs())):
                i, th = pulled[k]
                records.append((i, th, clock()))
                sample.offer(i, out)
        except Exception as e:
            log(f"stream failed after {len(records)} images: {e!r}")
    else:
        raise ValueError(f"unknown entry kind {kind!r}")
    t_end = clock()
    if stretch is not None:
        stretch.finish(state["started"])
    done = [r for r in records if r[2] is not None]
    return done, t_end - t0, state["handed"], state["handed"] - len(done)


def make_pool(system, mix):
    """The mix's pool, as its client hands it over (numpy, in the mix's
    ``dtype``): made in set-up."""
    dtype = np.dtype(mix["dtype"])
    return [np.asarray(y).astype(dtype, copy=False)
            for y in system.make_pool(int(mix["pool"]))]


def run_cell(name, seed, seconds, trace, device="cuda", overrides=None,
             t_start=None):
    """Run the cell once and return the result object (the last line's)."""
    t_start = time.perf_counter() if t_start is None else t_start
    seed = int(seed) % (1 << 63)
    bench = spec.benchmark()
    cell = spec.workload(bench, name)
    cfg = dict(spec.config(cell["config"]), **(overrides or {}))
    mix = spec.mix(cell["traffic"])
    limits = spec.limits(name)
    system_mod = spec.module("configs", cell["config"])
    ref_mod = spec.module("reference", cell["config"])
    readers = spec.metrics(bench, cell, trace)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def phase(label, t):
        log(f"setup {label} {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    system = system_mod.System(cfg, seed, dev)
    pool = make_pool(system, mix)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    phase("inputs", t)
    t = time.perf_counter()
    system.build()
    phase("init", t)
    kind, fn = spec.module("entries", mix["entry"]).entry(system)
    t = time.perf_counter()
    warm = [pool[i % len(pool)] for i in range(int(mix["warmup"]))]
    if kind == "call":
        for y in warm:
            fn(y)
    else:
        list(fn(iter(warm)))
    if on_card:
        torch.cuda.synchronize()
    phase("warmup", t)
    counts0 = system.counters()

    stretch = (tracing.Stretch(**mix["trace"]) if trace and on_card
               else None)
    sample = Sample(int(mix["sample"]), seed)
    setup_s = time.perf_counter() - t_start
    records, window_s, attempted, failed = window(
        kind, fn, pool, mix, seed, seconds, sample, stretch)
    counts = {k: v - counts0.get(k, 0) for k, v in system.counters().items()}
    log(f"window {window_s:.3f} s, {len(records)} of {attempted} requests "
        f"back, counters over the window "
        + " ".join(f"{k}={v}" for k, v in counts.items()))
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": int(cell["chips"]), "memory_peak_bytes": peak}

    ctx = SimpleNamespace(  # what a metric reader is given
        cfg=cfg, system=system, records=records, window_s=window_s,
        setup_s=setup_s, summary=stretch.summary if stretch else None,
        device=dev)
    metrics = {}
    for entry, reader in readers:
        value = reader.read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if stretch is not None and stretch.summary is not None:
        s = stretch.summary
        device.update(busy_s=s["busy_s"], window_s=s["wall_s"])
        result["breakdown"] = tracing.breakdown(s)
        log(f"trace {s['requests']} requests, {s['device_ops']} device "
            f"operations, busy {s['busy_s']:.4f} of {s['wall_s']:.4f} s, "
            f"read in {s['read_s']:.3f} s")
        from indigo_tpu_torch.profiling import measure_hbm_bandwidth
        from portbench.roofline.bounds import HBM_BYTES_PER_S
        rate = measure_hbm_bandwidth(device=dev)
        log(f"measured copy rate {rate:.6g} B/s, "
            f"{rate / HBM_BYTES_PER_S:.4f} of the data sheet's")

    kept = sample.kept
    geometry = (system.traj, system.maps)
    system.free()
    del fn, system, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(ref_mod, cfg, geometry, dev, pool, kept, limits)
    log(f"reference {time.perf_counter() - t:.3f} s over {len(kept)} "
        "sampled outputs")
    result["correct"] = bool(
        failed == 0 and records and len(kept) > 0
        and all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = checks
    return result


def check(ref_mod, cfg, geometry, dev, pool, kept, limits):
    """Each compared number, the worst over the sampled outputs, beside its
    limit. The reference is built here from the configuration and the
    benchmark's own inputs (trajectory, maps, k-space), never from the
    program's state."""
    names = list(limits)
    worst = {k: 0.0 for k in names}
    if kept:
        ref = ref_mod.Reference(cfg, *geometry, "float64", dev)
        answers = {}
        for i, out in kept:
            if i not in answers:
                answers[i] = ref.answer(pool[i])
            nums = (ref.numbers(pool[i], answers[i], out) if finite(out)
                    else {k: NOT_FINITE for k in names})
            for k in names:
                worst[k] = max(worst[k], float(nums[k]))
        del ref, answers
    return {k: {"value": worst[k], "limit": float(limits[k]["limit"])}
            for k in names}


def finite(out):
    a = np.asarray(out)
    return a.size > 0 and bool(np.all(np.isfinite(a)))
