"""The BEATs encoder, patches, position convolution and its layers (span
bsed.serve.beats), device time, ms a batch."""
from portbench.harness.program import device_ms
read = device_ms("bsed.serve.beats")
