"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (backbone only).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2409.12191; hf].
The vision frontend is a stub per the assignment: input_specs() provides
precomputed patch embeddings merged into the token stream at masked positions,
plus 3-axis M-RoPE position ids (temporal/height/width; sections 16/24/24
halves of head_dim=128).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        period=(LayerSpec("attn", attn_kind="full", ffn="dense"),),
        mrope_sections=(16, 24, 24),
        rope_theta=1000000.0,
        vlm=True,
        shape_skips={
            "long_500k": "pure full-attention arch; sub-quadratic required (per spec)"
        },
    )
)
