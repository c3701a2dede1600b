"""The SENSE normal operator K1's share of its roofline over the traced
stretch (the stream cell): ``lib.readers.normal_op_roofline``."""
from portbench.lib.readers import normal_op_roofline as read  # noqa: F401
