"""DtoH copy time per request, ms, from the trace (the stream cell)."""
from portbench.lib.readers import egress_ms as read  # noqa: F401
