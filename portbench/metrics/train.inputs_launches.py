"""The train step's inputs phase (span bsed.train.inputs): launches that
started device work, a step."""
from portbench.harness.program import launches
read = launches("bsed.train.inputs")
