"""flash_attn_roofline.prefill (%): the attention kernel's bound over its
summed device time in the window's prefills.  A request of s tokens
launches the kernel once a layer over (1, s) queries and keys; its bound
is the larger of its operations over the visible pairs (window applied)
at the bf16 peak and its bytes at the memory peak (``yardstick``).  The
launches are matched to the requests in order; where their count is not
the layers' times the requests', nothing is read.  Moves
``prefill_tok_s``."""
from perfbench.metrics._common import flash_launches
from perfbench.yardstick import attention_bound, geometry


def read(ctx):
    lengths = ctx.work.get("prefill_lengths")
    launches = flash_launches(ctx)
    if not lengths or not launches or ctx.peak is None:
        return None
    g = geometry(ctx.config)
    if len(launches) != g["layers"] * len(lengths):
        return None
    bound = sum(g["layers"] * attention_bound(g, 1, s, ctx.peak)[0]
                for s in lengths)
    return 100.0 * bound / sum(e - s for s, e in launches)
