"""Dense GQA transformer (llama / qwen style): prefill and decode.

Counterpart of ``repro.models.transformer`` for the dense GQA
configurations; the causal self-attention of the prefill runs kernel B8
(``kernels/flash_attention.py``).  MLA, MoE and the int8 KV cache are not
ported yet (ROADMAP A13).
"""
