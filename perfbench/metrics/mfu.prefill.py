"""mfu.prefill (%): the model FLOPs of the window's prefills (2 x the
layers' matrix parameters x tokens, 4 x visible pairs x d_head x q heads,
the head at the last position) over the bf16 peak and the traced window's
wall time.  Moves ``prefill_tok_s``."""
from perfbench.yardstick import geometry, prefill_flops


def read(ctx):
    lengths = ctx.work.get("prefill_lengths")
    if not lengths or ctx.peak is None or ctx.window_s <= 0:
        return None
    g = geometry(ctx.config)
    flops = sum(prefill_flops(g, s) for s in lengths)
    return 100.0 * flops / (ctx.window_s * ctx.peak["bf16_flops"])
