"""BEATs' attention with its gated relative-position bias
(``ops/rel_attention.gated_rel_attention``): the least time its calls'
work allows over their device time, %.

The work is the algorithm's at the call's shapes, whatever implements it:
q·kᵀ and the weights times v, 4·B·H·L²·D operations in q's dtype; q, k, v
and the output read or written once, the gate (B, H, L) and the bias
table (buckets × H) read once. The (B, H, L, L) bias that the present
entry materialises is not counted: a kernel that builds it from the table
in place needs no such bytes."""
from portbench.harness.readers import roofline

SPAN = "portbench.beats_attn"
read = roofline(SPAN)


def attn_work(num_buckets: int):
    """The work of one call ``gated_rel_attention(q, k, v, gate, bias)``
    with a table of ``num_buckets`` rows."""
    def work_of(args, kwargs, out):
        q = args[0]
        b, h, n, d = q.shape
        it = q.element_size()
        nbytes = (4 * b * h * n * d + b * h * n + num_buckets * h) * it
        dtype = str(q.dtype).split(".")[-1]
        return float(nbytes), {dtype: 4.0 * b * h * n * n * d}
    return work_of


def spans(config):
    return [("bsed_tpu_torch.ops.rel_attention", "gated_rel_attention", SPAN,
             attn_work(config["beats"]["num_buckets"]))]
