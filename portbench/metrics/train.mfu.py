"""Model FLOPs of the train steps (the teacher's forwards, the student's
forwards and backwards) over their time on the host clock, in the traced
run's unprofiled units, % of the configuration's peak for its training
precision."""
from portbench.harness.readers import mfu as read  # noqa: F401
