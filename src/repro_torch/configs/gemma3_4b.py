"""gemma3-4b [dense] — 5:1 local:global interleave, 128k context.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144 [hf:google/gemma-3-1b-pt
family; unverified]. 34 layers => period of 17 with 3 global layers
(28 local : 6 global ≈ 4.7:1; closest realizable; documented in DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_l = LayerSpec("attn", attn_kind="swa", ffn="dense")
_g = LayerSpec("attn", attn_kind="full", ffn="dense")

CONFIG = register(
    ArchConfig(
        arch_id="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        period=(_l, _l, _l, _l, _l, _g, _l, _l, _l, _l, _l, _g, _l, _l, _l, _l, _g),
        window=1024,
        qk_norm=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        shape_skips={},
    )
)
