"""The train step's inputs phase (span bsed.train.inputs): host self
time, ms a step."""
from portbench.harness.program import host_ms
read = host_ms("bsed.train.inputs")
