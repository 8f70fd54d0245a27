"""% of the busy stretch (device activity alone profiled) in which
the device ran no operation, serving."""
from portbench.harness.readers import idle_share as read  # noqa: F401
