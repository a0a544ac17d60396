"""gemma3-1b [dense] — 5:1 local:global interleave, 128k context.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 [hf:google/gemma-3-1b-pt].
26 layers are not divisible by 6, so we use a period of 13 with 2 global layers
(22 local : 4 global = 5.5:1, the closest realizable ratio; documented in
DESIGN.md). Sliding window = 512 (gemma3 default).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_l = LayerSpec("attn", attn_kind="swa", ffn="dense")
_g = LayerSpec("attn", attn_kind="full", ffn="dense")

CONFIG = register(
    ArchConfig(
        arch_id="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262144,
        period=(_l, _l, _l, _l, _l, _g, _l, _l, _l, _l, _l, _g, _l),
        window=512,
        qk_norm=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        # mostly-local attention: per-step decode cost is bounded => runs
        shape_skips={},
    )
)
