"""The BEATs encoder (span bsed.serve.beats): launches that started
device work, a batch."""
from portbench.harness.program import launches
read = launches("bsed.serve.beats")
