"""HTS-AT from bn0 through its final LayerNorm (span bsed.serve.htsat):
launches that started device work, a batch."""
from portbench.harness.program import launches
read = launches("bsed.serve.htsat")
