"""flash_attn_roofline.train (%): the attention kernel's bound over its
summed device time in the window's train steps.  Every launch is the
forward (or the recomputation's forward) over (rows, seq_len) queries and
keys; its bound is the larger of its operations over the visible pairs at
the bf16 peak and its bytes at the memory peak (``yardstick``).  The
backward runs the plain version, not the kernel.  Moves ``train_tok_s``."""
from perfbench.metrics._common import flash_launches
from perfbench.yardstick import attention_bound, geometry


def read(ctx):
    launches = flash_launches(ctx)
    if not ctx.work.get("train_steps") or not launches or ctx.peak is None:
        return None
    g = geometry(ctx.config)
    one = attention_bound(g, ctx.work["rows"], ctx.work["seq_len"],
                          ctx.peak)[0]
    return 100.0 * one * len(launches) / sum(e - s for s, e in launches)
