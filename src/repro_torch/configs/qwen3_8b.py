"""qwen3-8b [dense] — qk_norm, GQA. 36L d=4096 32H kv=8 d_ff=12288 vocab=151936.

[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        period=(LayerSpec("attn", attn_kind="full", ffn="dense"),),
        qk_norm=True,
        rope_theta=1000000.0,
        shape_skips={
            "long_500k": "pure full-attention arch; sub-quadratic required (per spec)"
        },
    )
)
