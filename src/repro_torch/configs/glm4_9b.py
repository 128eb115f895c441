"""glm4-9b: 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 — RoPE, GQA
[hf:THUDM/glm-4-9b; hf]"""

from repro_torch.models.lm_types import LMConfig

CONFIG = LMConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, rope_theta=10000.0,
)

REDUCED = LMConfig(
    name="glm4-9b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=503, rope_theta=10000.0,
)
