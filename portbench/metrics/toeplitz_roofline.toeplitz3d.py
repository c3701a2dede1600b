"""K2's share of its roofline over the traced stretch (the tree cell): the
frozen bound of each ``indigo.toeplitz`` apply the stretch recorded, at its
batch ``K`` (the coils: 2.276 ms at 256^3 and 8), over the device time of
the kernels of the Toeplitz pass family (``kern_fwd``, ``kern_x``,
``kern_inv``). K1, the family's other member, does not run in this cell
(its ``k1_launches`` counter stays 0). Nothing to read where no apply was
recorded (a program without the span) or no such kernel ran."""
import re

from portbench.lib import spans
from portbench.lib.readers import kernel_seconds
from portbench.roofline.bounds import toeplitz_bound

KERNELS = re.compile(r"^kern_(fwd|x|inv)<")


def read(ctx):
    s = ctx.summary
    recs = spans.records() if s else None
    applies = [r for r in recs or () if r.name == "indigo.toeplitz"]
    seconds = kernel_seconds(s, KERNELS)[0] if applies else 0.0
    if not seconds:
        return None
    shape = tuple(ctx.cfg["image"])
    bound_ms = sum(toeplitz_bound(shape, int(r.attrs["K"]), 0)[0]
                   for r in applies)
    return 100.0 * bound_ms / (1e3 * seconds)
