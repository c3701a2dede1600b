"""CG's own device ms per request over the traced stretch (the interactive
cell): ``indigo.solve`` less its ``indigo.normal_op`` descendants
(``lib.spans.cg_self_ms``)."""
from portbench.lib.spans import cg_self_ms as read  # noqa: F401
