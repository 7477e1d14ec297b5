"""The five assigned LM architectures (exact public configs) + smoke variants.

A copy of the reference's ``configs/lm_archs.py`` as data; the port builds
all five (dense GQA, MLA + MoE, GQA + MoE).

long_500k note (DESIGN.md §5): these are all pure full-attention archs, so a
500k PREFILL is out of scope (quadratic); the assigned long_500k cell is
DECODE (one token against a 524,288-token KV cache), which is O(L) per token
— we lower it with the cache sequence-sharded over (data, model)
(context-parallel decode).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer.config import (
    MLAConfig,
    MoEConfig,
    TransformerConfig,
)


def _smoke(name, **kw):
    base = dict(
        name=name + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, rope_theta=10_000.0, dtype="float32",
        param_dtype="float32", max_seq_len=64, remat=False,
    )
    base.update(kw)
    return TransformerConfig(**base)


@register
def qwen2_5_14b() -> ArchSpec:
    """[hf:Qwen/Qwen2.5-14B] GQA + QKV bias."""
    cfg = TransformerConfig(
        name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=13824, vocab_size=152064, qkv_bias=True,
        rope_theta=1_000_000.0, max_seq_len=524288,
    )
    return ArchSpec(
        arch_id="qwen2.5-14b", family="lm", model_cfg=cfg,
        smoke_cfg=_smoke("qwen", qkv_bias=True),
        shapes=lm_shapes(train_micro=2),
        notes="40 heads over a 16-way model axis pads to 48 (GSPMD); "
              "see roofline useful-FLOP ratio.",
    )


@register
def llama3_405b() -> ArchSpec:
    """[arXiv:2407.21783] Llama-3 405B."""
    cfg = TransformerConfig(
        name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
        n_kv_heads=8, d_ff=53248, vocab_size=128256,
        rope_theta=500_000.0, max_seq_len=524288,
        param_dtype="bfloat16",  # documented deviation: bf16 master + moments
    )
    shapes = lm_shapes(train_micro=8)  # §Perf iter 4: collective volume
    # scales with microbatch count; seq-sharded boundary stash (iter 3)
    # frees the activation memory to halve it.
    from repro_torch.configs.base import ShapeCell
    shapes["decode_32k_int8"] = ShapeCell(
        "decode_32k_int8", "decode",
        dict(seq_len=32768, global_batch=128, kv_quant=True))
    return ArchSpec(
        arch_id="llama3-405b", family="lm", model_cfg=cfg,
        smoke_cfg=_smoke("llama405"),
        shapes=shapes,
        notes="bf16 master params + bf16 Adam moments to fit 16GB/chip on a "
              "single pod (fp32 fits at 512 chips); DESIGN.md §2.",
    )


@register
def llama3_2_1b() -> ArchSpec:
    """[hf:meta-llama/Llama-3.2-1B] small llama3, tied embeddings."""
    cfg = TransformerConfig(
        name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
        n_kv_heads=8, d_ff=8192, vocab_size=128256, tie_embeddings=True,
        rope_theta=500_000.0, max_seq_len=524288,
    )
    return ArchSpec(
        arch_id="llama3.2-1b", family="lm", model_cfg=cfg,
        smoke_cfg=_smoke("llama1b", tie_embeddings=True),
        shapes=lm_shapes(train_micro=4),
    )


@register
def deepseek_v2_236b() -> ArchSpec:
    """[arXiv:2405.04434] MLA kv_lora=512; 2 shared + 160 routed top-6."""
    cfg = TransformerConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, d_ff=12288,  # dense width for the first dense layer
        vocab_size=102400, attention="mla",
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_expert_ff=1536,
                      capacity_factor=1.25, first_dense_layers=1),
        rope_theta=10_000.0, max_seq_len=524288,
    )
    return ArchSpec(
        arch_id="deepseek-v2-236b", family="lm", model_cfg=cfg,
        smoke_cfg=_smoke(
            "dsv2", attention="mla",
            mla=MLAConfig(kv_lora_rank=16, q_lora_rank=24,
                          qk_nope_head_dim=8, qk_rope_head_dim=4,
                          v_head_dim=8),
            moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert_ff=32,
                          first_dense_layers=1, capacity_factor=2.0),
            n_layers=3),
        shapes=lm_shapes(train_micro=8),
        notes="assignment lists 'GQA kv=128'; the MLA note (kv_lora=512) is "
              "the actual DeepSeek-V2 attention — implemented as MLA with "
              "128 heads. Decode uses the absorbed formulation.",
    )


@register
def grok_1_314b() -> ArchSpec:
    """[hf:xai-org/grok-1] 8 experts top-2, every layer MoE."""
    cfg = TransformerConfig(
        name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=32768,
        vocab_size=131072,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_expert_ff=32768,
                      capacity_factor=1.25, first_dense_layers=0),
        rope_theta=10_000.0, max_seq_len=524288,
    )
    return ArchSpec(
        arch_id="grok-1-314b", family="lm", model_cfg=cfg,
        smoke_cfg=_smoke(
            "grok",
            moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert_ff=64,
                          capacity_factor=2.0),
            n_layers=2),
        shapes=lm_shapes(train_micro=8),
    )
