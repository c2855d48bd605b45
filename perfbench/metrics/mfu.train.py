"""mfu.train (%): the model FLOPs of the window's train steps (6 x (the
layers' matrix parameters + the head's) x tokens, 12 x visible pairs x
d_head x q heads for attention's forward and backward; recomputation not
counted) over the bf16 peak and the traced window's wall time.  Moves
``train_tok_s``."""
from perfbench.yardstick import geometry, train_flops


def read(ctx):
    steps = ctx.work.get("train_steps")
    if not steps or ctx.peak is None or ctx.window_s <= 0:
        return None
    g = geometry(ctx.config)
    flops = steps * train_flops(g, ctx.work["rows"], ctx.work["seq_len"])
    return 100.0 * flops / (ctx.window_s * ctx.peak["bf16_flops"])
