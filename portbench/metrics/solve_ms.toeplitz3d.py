"""``solvers.cg``'s device ms per solve over the traced stretch (the tree
cell): ``indigo.solve`` (``lib.spans.solve_ms``)."""
from portbench.lib.spans import solve_ms as read  # noqa: F401
