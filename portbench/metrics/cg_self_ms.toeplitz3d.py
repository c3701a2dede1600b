"""``solvers.cg``'s own device ms per solve over the traced stretch (the
tree cell): ``indigo.solve`` less its ``indigo.normal_op`` descendants, so
CG's vector work and the ``lamda * v`` add (``lib.spans.cg_self_ms``)."""
from portbench.lib.spans import cg_self_ms as read  # noqa: F401
