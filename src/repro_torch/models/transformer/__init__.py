"""Transformer (llama / qwen / deepseek-v2 / grok-1): prefill and decode.

Counterpart of ``repro.models.transformer``'s serving path: dense GQA, MLA
(``mla.py``), MoE (``moe.py``) and the int8 KV cache (``kv_quant.py``).
The causal self-attention of a GQA prefill runs kernel B8
(``kernels/flash_attention.py``); MLA and MoE compute in plain PyTorch, as
the reference does in plain jnp.
"""
