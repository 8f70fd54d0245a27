"""BEATs' front end, the 2:1 decimation and the Kaldi fbank (span
bsed.serve.fbank), device time, ms a batch."""
from portbench.harness.program import device_ms
read = device_ms("bsed.serve.fbank")
