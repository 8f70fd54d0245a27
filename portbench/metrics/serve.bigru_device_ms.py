"""The BiGRU's device time (span bsed.serve.bigru: projections and K4),
ms a batch."""
from portbench.harness.program import device_ms
read = device_ms("bsed.serve.bigru")
