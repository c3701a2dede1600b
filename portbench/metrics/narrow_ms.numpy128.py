"""Host ms per ``indigo.narrow`` over the traced stretch (the numpy128
cell): the program's host-side cast of the client's complex128 k-space to
complex64 at its boundary, before anything crosses to the card. None where
the program recorded no such span (complex64 input, or a program without
it)."""
from portbench.lib import spans


def read(ctx):
    recs = spans.records() if ctx.summary is not None else None
    ms = [r.host_ms for r in recs or ()
          if r.name == "indigo.narrow" and r.end_ns is not None]
    return sum(ms) / len(ms) if ms else None
