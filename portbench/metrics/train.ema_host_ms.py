"""The train step's ema phase (span bsed.train.ema): host self time, ms a
step."""
from portbench.harness.program import host_ms
read = host_ms("bsed.train.ema")
