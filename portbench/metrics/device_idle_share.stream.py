"""Device idle share of the traced stretch, % (the stream cell)."""
from portbench.lib.readers import idle_share as read  # noqa: F401
