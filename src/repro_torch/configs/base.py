"""Architecture configuration shared by all model families."""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # -- MoE --
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_mode: str = "tp"  # tp: expert-tensor-parallel | ep: all_to_all expert parallel
    # -- SSM (mamba2 / SSD) --
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # -- hybrid (recurrentgemma): layer pattern, local attention --
    local_window: int = 0  # sliding-window size for local attention layers
    attention_period: int = 0  # 1 attention layer every `period` layers (Griffin: 3)
    conv_width: int = 4
    # -- encoder-decoder (whisper) --
    enc_layers: int = 0
    enc_seq: int = 0  # encoder frames (whisper-tiny: 1500)
    max_pos: int = 32_768  # learned-position table size (audio decode shapes)
    # -- positions / misc --
    rope_type: str = "rope"  # rope | mrope | learned | none
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    rope_theta: float = 10_000.0
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    # training schedule (minicpm uses WSD)
    schedule: str = "cosine"  # cosine | wsd
    # pad the unembedding vocab to a multiple (TP-aligned logits; 0 = off)
    vocab_pad_to: int = 0
    # attention flavor used at long sequence lengths
    attn_chunk: int = 1024
    notes: str = ""

    @property
    def kq_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def quadratic_attention(self) -> bool:
        """True if the arch has unbounded full attention (skips long_500k)."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.local_window > 0:
            return False
        return True

    @property
    def param_count(self) -> int:
        """Approximate total parameters (used for 6ND model-FLOP estimates)."""
        d, f, L, v = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.kq_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.family == "ssm":
            di = self.ssm_expand * d
            per_layer = d * 2 * di + di * d + di * (2 * self.ssm_state) + di
        elif self.family == "moe":
            ff = 3 * d * f * self.n_experts + d * self.n_experts
            per_layer = attn + ff
        elif self.family == "hybrid":
            n_attn = L // max(1, self.attention_period)
            di = d  # rnn width ~ d_model
            rec = 2 * d * di + di * d + di * self.conv_width + 2 * di
            mlp = 3 * d * f
            return v * d + (L - n_attn) * (rec + mlp) + n_attn * (attn + mlp) + d
        else:
            mult = 3 if self.act == "swiglu" else 2
            per_layer = attn + mult * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb + L * per_layer
        if self.enc_layers:
            total += self.enc_layers * (attn + (3 if self.act == "swiglu" else 2) * d * f)
            total += L * (attn)  # decoder cross-attention
        return int(total)

    @property
    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts)."""
        if self.family != "moe":
            return self.param_count
        d, f, L = self.d_model, self.d_ff, self.n_layers
        inactive = 3 * d * f * (self.n_experts - self.top_k) * L
        return int(self.param_count - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the evaluation matrix."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
