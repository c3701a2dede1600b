"""The solve's device ms per request over the traced stretch (the training
cell, the forward with its graph): ``indigo.solve``
(``lib.spans.solve_ms``)."""
from portbench.lib.spans import solve_ms as read  # noqa: F401
