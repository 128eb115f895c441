"""qwen2-moe-a2.7b: 24L d=2048 16H (kv=16) vocab=151936, MoE 60e top-4
+ 4 shared experts (d_expert=1408) [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].
60 routed experts pad to 64 on the 16-wide model axis (padded experts get
-inf router logits => zero tokens); <7% parameter pad, noted in DESIGN.md."""

from repro_torch.models.lm_types import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, rope_theta=1000000.0, qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408,
                  d_shared=1408),
)

REDUCED = LMConfig(
    name="qwen2-moe-reduced", family="moe",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=211, qkv_bias=True,
    moe=MoEConfig(n_experts=6, top_k=2, n_shared=1, d_expert=64, d_shared=64),
)
