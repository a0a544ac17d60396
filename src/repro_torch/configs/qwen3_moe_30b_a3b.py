"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk_norm.

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per-expert) vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]. Param-count check: 48x128x3x2048x768 ~= 29B total,
~3.3B active (top-8).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        period=(LayerSpec("attn", attn_kind="full", ffn="moe"),),
        n_experts=128,
        moe_top_k=8,
        moe_d_ff=768,
        qk_norm=True,
        rope_theta=1000000.0,
        shape_skips={
            "long_500k": "pure full-attention arch; sub-quadratic required (per spec)"
        },
    )
)
