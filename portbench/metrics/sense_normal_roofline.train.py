"""K1's share of its roofline over the traced stretch of the training cell:
the frozen bound of the normal-operator applications that the stretch's
requests ask for, ``iters`` CG steps each in the forward and as many on
the cotangents in the backward, over the device time of K1's kernels:
twice ``lib.readers.normal_op_roofline``, which counts the forward's.
Nothing to read where K1 did not run."""
from portbench.lib.readers import normal_op_roofline


def read(ctx):
    share = normal_op_roofline(ctx)
    return None if share is None else 2 * share
