"""The predictor head's device time (span bsed.serve.head), ms a
batch."""
from portbench.harness.program import device_ms
read = device_ms("bsed.serve.head")
