"""The train step's backward phase (span bsed.train.backward): host self
time, ms a step."""
from portbench.harness.program import host_ms
read = host_ms("bsed.train.backward")
