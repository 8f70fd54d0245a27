"""The train step's optimizer phase (span bsed.train.optimizer): launches
that started device work, a step."""
from portbench.harness.program import launches
read = launches("bsed.train.optimizer")
