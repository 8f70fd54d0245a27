"""The train step's optimizer phase (span bsed.train.optimizer): host
self time, ms a step."""
from portbench.harness.program import host_ms
read = host_ms("bsed.train.optimizer")
