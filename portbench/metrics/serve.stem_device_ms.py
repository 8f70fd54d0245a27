"""The stem's device time (span bsed.serve.stem: the folded stem on K2,
or K5), ms a batch."""
from portbench.harness.program import device_ms
read = device_ms("bsed.serve.stem")
