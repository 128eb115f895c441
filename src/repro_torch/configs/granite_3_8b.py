"""granite-3-8b: 40L d=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 — GQA
[hf:ibm-granite/granite-3.0-2b-base; hf]"""

from repro_torch.models.lm_types import LMConfig

CONFIG = LMConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, rope_theta=10000.0, tie_embeddings=True,
)

REDUCED = LMConfig(
    name="granite-3-8b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=499, rope_theta=10000.0, tie_embeddings=True,
)
