"""LMConfig: one config dataclass covering all 10 assigned architectures
(a copy of the reference's ``repro.models.lm_types``; pure data).

Families:
  dense   — decoder-only GQA transformer (glm4, qwen2, qwen3, granite-3,
            llava backbone)
  moe     — dense skeleton with mixture-of-experts FFN (granite-moe, qwen2-moe)
  ssm     — xLSTM (mLSTM + sLSTM blocks)
  hybrid  — RecurrentGemma (RG-LRU recurrent blocks + local attention)
  encdec  — whisper (encoder–decoder, conv frontend stubbed)

Modality frontends ([vlm]/[audio]) are STUBS per the assignment:
``input_specs()`` provides precomputed patch/frame embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0           # routed experts
    top_k: int = 0
    n_shared: int = 0            # always-on shared experts (qwen2-moe)
    d_expert: int = 0            # per-expert FFN hidden width
    d_shared: int = 0            # shared-expert FFN hidden width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None       # default d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False               # qwen2
    qk_norm: bool = False                # qwen3
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"                  # swiglu | gelu
    attn_logit_softcap: float = 0.0

    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)

    # --- ssm (xLSTM) ---
    # block pattern over layers: 'm' = mLSTM, 's' = sLSTM; cycled.
    xlstm_pattern: str = "mmms"
    xlstm_chunk: int = 64                # chunkwise-parallel chunk length
    conv_width: int = 4                  # short conv in mLSTM blocks

    # --- hybrid (RecurrentGemma) ---
    # pattern over layers: 'r' = RG-LRU recurrence block, 'l' = local attention
    hybrid_pattern: str = "rrl"
    window: int = 2048                   # local-attention window
    rglru_d: Optional[int] = None        # recurrence width (default d_model)

    # --- encdec (whisper) ---
    n_enc_layers: int = 0
    n_audio_frames: int = 1500           # encoder input length (stub frontend)

    # --- modality stub ---
    frontend: str = "none"               # none | vision_stub | audio_stub

    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, for the ssm/hybrid families."""
        if self.family == "ssm":
            pat = self.xlstm_pattern
        elif self.family == "hybrid":
            pat = self.hybrid_pattern
        else:
            return ("a",) * self.n_layers
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def n_params(self) -> int:
        """Analytical parameter count (embeddings included once)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        kinds = self.layer_kinds()
        total = emb
        for k in kinds:
            if k == "a":                        # attention + FFN block
                attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
                if self.family == "moe":
                    m = self.moe
                    ffn = m.n_experts * 3 * d * m.d_expert + m.n_shared * 3 * d * m.d_shared + d * m.n_experts
                else:
                    ffn = 3 * d * self.d_ff
                total += attn + ffn + 2 * d
            elif k == "l":                      # local attention block (hybrid)
                attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
                total += attn + 3 * d * self.d_ff + 2 * d
            elif k == "r":                      # RG-LRU block
                dr = self.rglru_d or self.d_model
                total += 2 * d * dr + dr * d + dr * self.conv_width + 2 * dr + 3 * d * self.d_ff + 2 * d
            elif k == "m":                      # mLSTM
                total += 2 * d * 2 * d + (2 * d) * self.conv_width + 4 * 2 * d + 2 * d * d + 3 * d * self.d_ff + 2 * d
            elif k == "s":                      # sLSTM
                total += 4 * d * d + 4 * d + 3 * d * self.d_ff + 2 * d
        if self.family == "encdec":
            total += self.n_enc_layers * (4 * d * d + 3 * d * self.d_ff + 2 * d)
            total += self.n_layers * (4 * d * d + d)     # cross-attention
        return int(total)

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: only top-k + shared experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        m = self.moe
        dense_ffn_all = self.n_layers * m.n_experts * 3 * d * m.d_expert
        active_ffn = self.n_layers * m.top_k * 3 * d * m.d_expert
        return int(self.n_params() - dense_ffn_all + active_ffn)

    def validate(self) -> None:
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.family == "moe" and not (self.moe.n_experts > 0
                                         and self.moe.top_k > 0):
            raise ValueError("a moe config needs n_experts and top_k")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


ASSIGNED_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)
