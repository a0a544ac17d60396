"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887; hf].
Period of 8: one attention layer per 8 (1:7), MoE on every other layer.
Param-count check: 9 periods x ~44.2B + 1.07B embeddings = ~398B (matches).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_M = LayerSpec("mamba", ffn="moe")
_m = LayerSpec("mamba", ffn="dense")
_A = LayerSpec("attn", attn_kind="full", ffn="moe")
_a = LayerSpec("attn", attn_kind="full", ffn="dense")

CONFIG = register(
    ArchConfig(
        arch_id="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        # 1 attn : 7 mamba, MoE every other layer (even positions)
        period=(_M, _m, _M, _a, _M, _m, _M, _m),
        n_experts=16,
        moe_top_k=2,
        moe_d_ff=24576,
        rope_theta=10000.0,
        shape_skips={},  # hybrid (mamba-dominant) => long_500k runs
    )
)
