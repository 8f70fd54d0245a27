"""Model FLOPs of the served batches over their time on the host clock,
in the traced run's unprofiled units, % of the configuration's peak for
serving (bf16: 989 TFLOP/s)."""
from portbench.harness.readers import mfu as read  # noqa: F401
