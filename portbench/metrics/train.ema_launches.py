"""The train step's ema phase (span bsed.train.ema): launches that
started device work, a step."""
from portbench.harness.program import launches
read = launches("bsed.train.ema")
