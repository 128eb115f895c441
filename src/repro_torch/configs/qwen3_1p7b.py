"""qwen3-1.7b: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936 — qk_norm,
GQA [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.lm_types import LMConfig

CONFIG = LMConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    head_dim=128, d_ff=6144, vocab=151936, rope_theta=1000000.0, qk_norm=True,
)

REDUCED = LMConfig(
    name="qwen3-1.7b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=503, rope_theta=1000000.0, qk_norm=True,
)
