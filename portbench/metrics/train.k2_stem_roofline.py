"""K2 train, the folded train stem's epilogue forward
(``ops/stem_epilogue.stem_epilogue_fwd`` with dropout bits): the least
time its calls' work allows over their device time, %."""
from portbench.harness.readers import roofline

SPAN = "portbench.k2_stem"
read = roofline(SPAN)


def spans(config):
    from portbench.harness.spans import stem_fwd_work
    return [("bsed_tpu_torch.ops.stem_epilogue", "stem_epilogue_fwd", SPAN,
             stem_fwd_work)]
