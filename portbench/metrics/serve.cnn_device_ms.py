"""The conv blocks after the stem, blocks 3-6 (span bsed.serve.cnn),
device time, ms a batch."""
from portbench.harness.program import device_ms
read = device_ms("bsed.serve.cnn")
