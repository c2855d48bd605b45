"""idle_share.train (%): 1 - the union of the device's kernel, copy and
set intervals over the traced window's wall time.  Moves
``train_tok_s``."""
from perfbench.metrics._common import idle_share as read  # noqa: F401
