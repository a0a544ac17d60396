"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818; hf].
head_dim = 2560/32 = 80; mistral-style SWA window 4096 on every layer.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        period=(LayerSpec("attn", attn_kind="swa", ffn="dense"),),
        window=4096,
        rope_theta=10000.0,
        # SWA everywhere: decode cost bounded by window => long_500k runs
        shape_skips={},
    )
)
