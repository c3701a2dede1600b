"""HtoD copy time per request, ms, from the trace (the stream cell)."""
from portbench.lib.readers import ingress_ms as read  # noqa: F401
