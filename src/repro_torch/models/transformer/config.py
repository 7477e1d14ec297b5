"""Transformer configuration covering every registered LM architecture.

One dataclass expresses dense GQA (qwen/llama), MLA (deepseek-v2) and MoE
(deepseek-v2, grok-1) variants as data; per-arch instances live in
``repro_torch/configs/``, and the port builds all of them.  The
reference's mesh and compile knobs (activation and gradient sharding
specs, the custom weight-gradient path, scanned layers) have no
counterpart on one card; they return with multi-GPU (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0              # shared (always-on) experts
    d_expert_ff: int = 0           # per-expert FFN width
    capacity_factor: float = 1.25  # dispatch capacity multiplier
    first_dense_layers: int = 0    # leading layers that stay dense
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01  # load-balancing loss


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense-FFN width (or dense layers of MoE nets)
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads
    attention: Literal["gqa", "mla"] = "gqa"
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    qkv_bias: bool = False         # qwen2.5 uses bias on QKV only
    tie_embeddings: bool = False
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 32768
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # master param dtype
    remat: bool = True             # training knob, kept as data
    attn_chunk: int = 0            # plain attention: 0 -> dense; else q-chunked

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.attention == "mla" and self.mla is None:
            object.__setattr__(self, "mla", MLAConfig())
        if self.n_heads % self.n_kv_heads != 0 and self.attention == "gqa":
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, l = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.attention == "gqa":
            attn = d * (self.n_heads * self.d_head) + 2 * d * (
                self.n_kv_heads * self.d_head) + (self.n_heads * self.d_head) * d
        else:
            m = self.mla
            q = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim)
            kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank * (
                self.n_heads * (m.qk_nope_head_dim + m.v_head_dim))
            o = self.n_heads * m.v_head_dim * d
            attn = q + kv + o
        dense_ffn = 3 * d * self.d_ff
        if self.moe is None:
            ffn_total = l * dense_ffn
        else:
            moe_ffn = 3 * d * self.moe.d_expert_ff * (
                self.moe.n_experts + self.moe.n_shared) + d * self.moe.n_experts
            nd = self.moe.first_dense_layers
            ffn_total = nd * dense_ffn + (l - nd) * moe_ffn
        norms = l * 2 * d + d
        return emb + l * attn + ffn_total + norms

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared experts)."""
        if self.moe is None:
            return self.n_params
        d, l = self.d_model, self.n_layers
        moe_active = 3 * d * self.moe.d_expert_ff * (
            self.moe.top_k + self.moe.n_shared) + d * self.moe.n_experts
        moe_full = 3 * d * self.moe.d_expert_ff * (
            self.moe.n_experts + self.moe.n_shared) + d * self.moe.n_experts
        nd = self.moe.first_dense_layers
        return self.n_params - (l - nd) * (moe_full - moe_active)
