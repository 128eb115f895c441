"""recurrentgemma-9b: 38L d=4096 16H (GQA kv=1) d_ff=12288 vocab=256000 —
RG-LRU + local attn, pattern (r,r,l) x 12 + (r,r) [arXiv:2402.19427;
unverified]. Window 2048; sub-quadratic => runs long_500k."""

from repro_torch.models.lm_types import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    head_dim=256, d_ff=12288, vocab=256000, rope_theta=10000.0,
    hybrid_pattern="rrl", window=2048, tie_embeddings=True,
)

REDUCED = LMConfig(
    name="recurrentgemma-9b-reduced", family="hybrid",
    n_layers=5, d_model=32, n_heads=2, n_kv_heads=1,
    head_dim=16, d_ff=64, vocab=211, hybrid_pattern="rrl", window=8,
    tie_embeddings=True,
)
