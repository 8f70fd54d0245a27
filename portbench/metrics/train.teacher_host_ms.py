"""The train step's teacher phase (span bsed.train.teacher): host self
time, ms a step."""
from portbench.harness.program import host_ms
read = host_ms("bsed.train.teacher")
