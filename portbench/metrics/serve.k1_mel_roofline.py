"""K1, the mel front end (``ops/mel_kernel.fused_block_mel``): the least
time its calls' work allows over their device time, %."""
from portbench.harness.readers import roofline

SPAN = "portbench.k1_mel"
read = roofline(SPAN)


def spans(config):
    from portbench.harness.spans import mel_work
    from portbench.harness.work import mel_filterbank_support
    from portbench.reference.frontend import mel_filterbank
    live, nnz = mel_filterbank_support(mel_filterbank(config["audio"]))
    return [("bsed_tpu_torch.ops.mel_kernel", "fused_block_mel", SPAN,
             mel_work(live, nnz))]
