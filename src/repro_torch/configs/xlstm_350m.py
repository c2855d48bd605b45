"""xLSTM-350M [arXiv:2405.04517; unverified] — mLSTM blocks (d_ff=0: the
block carries its own 2x up-projection).  sLSTM blocks are implemented
(models/ssm.py + slstm_every knob) but the dry-run config uses the [1:0]
all-mLSTM variant so XLA cost analysis counts every FLOP exactly
(DESIGN.md §5)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    ssm_proj=2.0, slstm_every=0,
    gla_chunk=256,
)
