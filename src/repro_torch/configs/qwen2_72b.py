"""qwen2-72b: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — GQA,
QKV bias [arXiv:2407.10671; hf]"""

from repro_torch.models.lm_types import LMConfig

CONFIG = LMConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, rope_theta=1000000.0, qkv_bias=True,
)

REDUCED = LMConfig(
    name="qwen2-72b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=503, rope_theta=1000000.0, qkv_bias=True,
)
