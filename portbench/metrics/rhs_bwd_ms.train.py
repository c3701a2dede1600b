"""The rhs's reverse, device ms per request over the traced stretch (the
training cell): ``indigo.rhs_bwd``, from the rhs's cotangent to the
k-space gradient (the adjoint pad-DFT's gradient, the gridding's gather,
the weight, the permutation). None where the program records no such
span."""
from portbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "indigo.rhs_bwd")
