"""The train step's teacher phase (span bsed.train.teacher): launches
that started device work, a step."""
from portbench.harness.program import launches
read = launches("bsed.train.teacher")
