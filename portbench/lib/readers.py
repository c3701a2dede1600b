"""Readers that several metrics share; each metric's own file under
``metrics/`` names which one it is."""
from __future__ import annotations

import math
import re

from portbench.roofline.bounds import toeplitz_bound

# the hand-written SENSE normal operator K1's five passes, by kernel name
K1_KERNELS = re.compile(r"^kern_(fwd|x|inv)<")


def rate(ctx):
    """Requests whose image reached host memory, over the window's
    seconds (host clock)."""
    return len(ctx.records) / ctx.window_s if ctx.records else None


def p90(ctx):
    """The 90th percentile (nearest rank), over every request of the
    window, of the seconds from handing the k-space to the program to
    holding the image in host memory (host clock)."""
    if not ctx.records:
        return None
    s = sorted(done - handed for _, handed, done in ctx.records)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


def ingress_ms(ctx):
    """Device time of the host-to-device copies per request over the
    traced stretch (the k-space entering the program)."""
    s = ctx.summary
    if not s or not s["requests"] or not s["htod_s"]:
        return None
    return 1e3 * s["htod_s"] / s["requests"]


def egress_ms(ctx):
    """Device time of the device-to-host copies per request over the
    traced stretch (the image leaving the program)."""
    s = ctx.summary
    if not s or not s["requests"] or not s["dtoh_s"]:
        return None
    return 1e3 * s["dtoh_s"] / s["requests"]


def idle_share(ctx):
    """The share of the traced stretch's host wall in which no operation
    ran on the device: 100 (1 - union of CUDA activities / wall)."""
    s = ctx.summary
    if not s or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])


def kernel_seconds(summary, pattern):
    """(device seconds, launches) of the kernels whose names match."""
    hits = [(v, summary["count_by_name"][k])
            for k, v in summary["by_name"].items() if pattern.match(k)]
    return sum(v for v, _ in hits), sum(n for _, n in hits)


def normal_op_roofline(ctx):
    """K1's share of its roofline over the traced stretch: the frozen bound
    of the normal-operator applications that the stretch's requests ask for
    (``iters`` CG steps each, one image with every coil) over the device
    time of K1's kernels. Nothing to read where K1 did not run."""
    s = ctx.summary
    if not s or not s["requests"]:
        return None
    seconds, _ = kernel_seconds(s, K1_KERNELS)
    if not seconds:
        return None
    bound_ms, _ = toeplitz_bound(tuple(ctx.cfg["image"]), 1,
                                 int(ctx.cfg["coils"]))
    applications = s["requests"] * int(ctx.cfg["iters"])
    return 100.0 * applications * bound_ms / (1e3 * seconds)
