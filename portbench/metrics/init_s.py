"""Host seconds of the program's set-up span ``indigo.init`` (both cells):
``lib.spans.init_s``."""
from portbench.lib.spans import init_s as read  # noqa: F401
