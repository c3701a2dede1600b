"""The Toeplitz leaf's device ms per apply over the traced stretch (the tree
cell): ``indigo.toeplitz``, K2 with its batch-leading copies in and out."""
from portbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "indigo.toeplitz")
