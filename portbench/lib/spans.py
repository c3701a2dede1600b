"""Readers of the program's own spans (``indigo_tpu_torch.tracing``): the
per-layer metrics with ``source`` ``program_span``.

The program records a request span only while a profiler runs, so in a
traced run its buffer holds the traced stretch's spans, each with the
device ms between the CUDA events it took at enter and exit. Set-up
spans (``indigo.init``) it records in every run, on the host clock. A
program without spans (a checkout before them) reads None, as does a
span that was not recorded.
"""
from __future__ import annotations


def records():
    """The program's span records, or None where it has none."""
    try:
        from indigo_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def per_request(ctx, name, less=()):
    """Device ms of span ``name`` less those of its nearest descendants
    named in ``less``, summed and divided by the count of ``name``; None
    without a traced stretch."""
    recs = records() if ctx.summary is not None else None
    if not recs:
        return None
    from indigo_tpu_torch.tracing import self_ms
    values = [self_ms(s, recs, less) if less else s.device_ms
              for s in recs if s.name == name]
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def rhs_ms(ctx):
    """The rhs (perm gather, DCF weight, gridding adjoint, ``GridDFT``
    adjoint) without its ingress: ``indigo.rhs`` less ``indigo.ingress``."""
    return per_request(ctx, "indigo.rhs", ("indigo.ingress",))


def solve_ms(ctx):
    """The whole CG: ``indigo.solve``."""
    return per_request(ctx, "indigo.solve")


def cg_self_ms(ctx):
    """CG's own work: ``indigo.solve`` less its ``indigo.normal_op``
    descendants (the vector updates and inner products, the ``lamda * v``
    add, device idle inside the solve)."""
    return per_request(ctx, "indigo.solve", ("indigo.normal_op",))


def init_s(ctx):
    """Host seconds of the newest top-level ``indigo.init``: the program's
    set-up (DCF, gridding plan, Toeplitz spectrum, buffers to the card)."""
    recs = records()
    inits = [s for s in recs or () if s.name == "indigo.init"
             and s.parent is None and s.end_ns is not None]
    return inits[-1].host_ms / 1e3 if inits else None
