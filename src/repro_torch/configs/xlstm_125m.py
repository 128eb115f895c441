"""xlstm-125m: 12L d=768 4H vocab=50304 — sLSTM + mLSTM blocks
[arXiv:2405.04517; unverified]. Pattern (m,m,m,s) x 3."""

from repro_torch.models.lm_types import LMConfig

CONFIG = LMConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, xlstm_pattern="mmms", xlstm_chunk=64,
)

REDUCED = LMConfig(
    name="xlstm-125m-reduced", family="ssm",
    n_layers=4, d_model=32, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=211, xlstm_pattern="mmms", xlstm_chunk=8,
)
