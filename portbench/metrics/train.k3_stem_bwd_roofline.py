"""K3, the folded train stem's epilogue backward
(``ops/stem_epilogue.stem_epilogue_bwd``): the least time its calls' work
allows over their device time, %."""
from portbench.harness.readers import roofline

SPAN = "portbench.k3_stem_bwd"
read = roofline(SPAN)


def spans(config):
    from portbench.harness.spans import stem_bwd_work
    return [("bsed_tpu_torch.ops.stem_epilogue", "stem_epilogue_bwd", SPAN,
             stem_bwd_work)]
