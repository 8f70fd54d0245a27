"""The forward built in each call (span bsed.predict.build) over the
traced calls' wall time, %."""
from portbench.harness.program import share
read = share("bsed.predict.build")
