"""HTS-AT from bn0 through its final LayerNorm, the fold and the four
stages included (span bsed.serve.htsat), device time, ms a batch."""
from portbench.harness.program import device_ms
read = device_ms("bsed.serve.htsat")
