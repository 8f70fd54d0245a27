"""HTS-AT's window attention (``ops/window_attention.window_attention``):
the least time its calls' work allows over their device time, %.

The work is the algorithm's at the call's shapes, whatever implements it:
q·kᵀ and the weights times v within each window, 4·B·nW·h·N²·d
operations in q's dtype; q, k, v and the output read or written once, and
the block's relative-position table ((2w − 1)² × h) read once. The
(nW·h, N, N) bias that the present entry takes is not counted: a kernel
that builds it from the table and the shift in place needs no such
bytes. A port without the entry (one without HTS-AT) wraps nothing, and
the metric reads nothing."""
import importlib.util

from portbench.harness.readers import roofline

SPAN = "portbench.htsat_attn"
MODULE = "bsed_tpu_torch.ops.window_attention"
read = roofline(SPAN)


def attn_work(heads_of):
    """The work of one call ``window_attention(q, k, v, bias)``;
    ``heads_of`` maps a call's nW·h to its stage's (h, window side)."""
    def work_of(args, kwargs, out):
        q = args[0]
        b, nwh, n, d = q.shape
        h, w = heads_of[nwh]
        it = q.element_size()
        nbytes = (4 * b * nwh * n * d + (2 * w - 1) ** 2 * h) * it
        dtype = str(q.dtype).split(".")[-1]
        return float(nbytes), {dtype: 4.0 * b * nwh * n * n * d}
    return work_of


def spans(config):
    if importlib.util.find_spec(MODULE) is None:
        return []
    from portbench.harness.htsat import stages
    heads_of = {(side // w) ** 2 * heads: (heads, w)
                for side, _, heads, _, w in stages(config)}
    return [(MODULE, "window_attention", SPAN, attn_work(heads_of))]
