"""The coil tree's device ms per apply of the normal operator over the
traced stretch (the tree cell): ``indigo.normal_op`` less its
``indigo.toeplitz``, so the ``Diag`` map multiplies, the ``VStack`` split
and coil sum, and the ``KronI`` folds around the Toeplitz leaf."""
from portbench.lib.spans import per_request


def read(ctx):
    return per_request(ctx, "indigo.normal_op", ("indigo.toeplitz",))
