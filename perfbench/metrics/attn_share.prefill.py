"""attn_share.prefill (%): the attention kernel's share of the device's
busy time in the window.  Moves ``prefill_tok_s``."""
from perfbench.metrics._common import flash_launches


def read(ctx):
    launches = flash_launches(ctx)
    if not launches or ctx.busy_s <= 0:
        return None
    return 100.0 * sum(e - s for s, e in launches) / ctx.busy_s
