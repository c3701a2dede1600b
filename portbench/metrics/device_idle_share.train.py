"""Device idle share of the traced stretch, % (the training cell)."""
from portbench.lib.readers import idle_share as read  # noqa: F401
