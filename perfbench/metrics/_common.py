"""Shared by the per-layer readers: the attention kernel's launches in a
trace, by the CUDA function names of the program's
``kernels/csrc/flash_attention.cu`` (frozen here: a kernel renamed is a
kernel this reader no longer sees), and the device's idle share."""
import re

FLASH_KERNELS = re.compile(r"\bflash_(mma_)?kernel\b")


def flash_launches(ctx) -> list:
    """(start_s, end_s) of each attention kernel launch in the window."""
    return [(s, e) for name, s, e in ctx.device if FLASH_KERNELS.search(name)]


def idle_share(ctx):
    """1 - the union of the device's kernel, copy and set intervals over
    the traced window's wall time, in %."""
    if ctx.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
