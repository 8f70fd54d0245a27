"""The train step's student phase (span bsed.train.student): launches
that started device work, a step."""
from portbench.harness.program import launches
read = launches("bsed.train.student")
