"""CG's reverse, device ms per request over the traced stretch (the
training cell): ``indigo.solve_bwd``, from the image's cotangent to the
rhs's, with K1 on each cotangent. None where the program records no such
span."""
from portbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "indigo.solve_bwd")
