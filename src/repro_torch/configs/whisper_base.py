"""whisper-base: 6L(enc)+6L(dec) d=512 8H d_ff=2048 vocab=51865 — enc-dec,
conv frontend STUB (input_specs() provides (B, 1500, d) frame embeddings)
[arXiv:2212.04356; unverified].

Encoder-decoder: decode_32k RUNS (decoder self-KV + cross-KV); long_500k
SKIPPED (full-attention decoder)."""

from repro_torch.models.lm_types import LMConfig

CONFIG = LMConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, frontend="audio_stub", n_audio_frames=1500,
)

REDUCED = LMConfig(
    name="whisper-base-reduced", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=211, frontend="audio_stub", n_audio_frames=16,
)
