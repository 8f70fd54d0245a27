"""K4, the BiGRU's recurrences (``ops/gru_kernel.recurrence``, the entry
``HoistedBiGRU`` binds when it is built, after the harness has wrapped
it): the least time its calls' work allows over their device time, %."""
from portbench.harness.readers import roofline

SPAN = "portbench.k4_gru"
read = roofline(SPAN)


def spans(config):
    from portbench.harness.spans import gru_work
    return [("bsed_tpu_torch.ops.gru_kernel", "recurrence", SPAN, gru_work)]
