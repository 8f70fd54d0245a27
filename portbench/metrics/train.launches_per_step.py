"""Device operations (kernels, copies, sets) a traced train step: the
host's dispatch load."""
from portbench.harness.readers import launches_per_unit as read  # noqa: F401
