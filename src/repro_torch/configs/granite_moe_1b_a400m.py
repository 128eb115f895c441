"""granite-moe-1b-a400m: 24L d=1024 16H (GQA kv=8) vocab=49155,
MoE 32e top-8 d_expert=512 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.models.lm_types import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, rope_theta=10000.0, tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
)

# capacity_factor 4.0: drop-free routing at smoke-test sizes, so decode
# (never capacity-limited at batch 1) matches teacher-forced forward exactly.
REDUCED = LMConfig(
    name="granite-moe-reduced", family="moe",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=211, tie_embeddings=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, capacity_factor=4.0),
)
