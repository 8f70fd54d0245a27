"""The train step's student phase (span bsed.train.student): host self
time, ms a step."""
from portbench.harness.program import host_ms
read = host_ms("bsed.train.student")
