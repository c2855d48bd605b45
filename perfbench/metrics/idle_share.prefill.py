"""idle_share.prefill (%): 1 - the union of the device's kernel, copy and
set intervals over the traced window's wall time.  Moves
``prefill_tok_s``."""
from perfbench.metrics._common import idle_share as read  # noqa: F401
