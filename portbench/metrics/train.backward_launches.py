"""The train step's backward phase (span bsed.train.backward): launches
that started device work, a step."""
from portbench.harness.program import launches
read = launches("bsed.train.backward")
