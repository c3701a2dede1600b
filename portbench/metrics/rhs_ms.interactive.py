"""The rhs's device ms per request over the traced stretch (the interactive
cell): ``indigo.rhs`` less its ``indigo.ingress`` (``lib.spans.rhs_ms``)."""
from portbench.lib.spans import rhs_ms as read  # noqa: F401
