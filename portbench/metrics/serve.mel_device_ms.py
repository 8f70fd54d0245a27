"""The mel front end's device time (span bsed.serve.mel: K1, or the dense
path), ms a batch."""
from portbench.harness.program import device_ms
read = device_ms("bsed.serve.mel")
