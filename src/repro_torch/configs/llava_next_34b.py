"""llava-next-34b: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 —
anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Transformer BACKBONE only: the anyres vision frontend is a STUB —
input_specs() provides precomputed patch embeddings (B, S, d)."""

from repro_torch.models.lm_types import LMConfig

CONFIG = LMConfig(
    name="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, rope_theta=5000000.0, frontend="vision_stub",
)

REDUCED = LMConfig(
    name="llava-next-34b-reduced", family="dense",
    n_layers=2, d_model=56, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=499, frontend="vision_stub",
)
