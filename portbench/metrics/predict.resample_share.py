"""The resample of the WAVs read (span bsed.predict.resample) over the
traced calls' wall time, %."""
from portbench.harness.program import share
read = share("bsed.predict.resample")
