"""grok-1-314b [moe] — 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072 [hf:xai-org/grok-1].
Param-count check: 64 x (8x3x6144x32768 MoE + attn) + embeddings ~= 316B.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        period=(LayerSpec("attn", attn_kind="full", ffn="moe"),),
        n_experts=8,
        moe_top_k=2,
        moe_d_ff=32768,
        rope_theta=10000.0,
        shape_skips={
            "long_500k": "pure full-attention arch; sub-quadratic required (per spec)"
        },
    )
)
