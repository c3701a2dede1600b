"""The backward's device ms per request over the traced stretch (the
training cell): ``indigo.backward``, from the image's cotangent entering
the graph to the k-space gradient. None where the program records no such
span."""
from portbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "indigo.backward")
