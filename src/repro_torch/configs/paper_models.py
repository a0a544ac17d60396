"""The paper's own evaluation models (Table 3): LLaMA 2 and Qwen 2.5 variants
(copy of `repro.configs.paper_models`).

The 3D-parallel settings (TP, DP, PP) of Table 3 come with them; the models
are selectable via --arch like the other architectures.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_DENSE = (LayerSpec("attn", attn_kind="full", ffn="dense"),)


def _dense(arch_id, n_layers, d_model, n_heads, n_kv_heads, d_ff, vocab, theta=10000.0, qk_norm=False):
    return register(
        ArchConfig(
            arch_id=arch_id,
            family="dense",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            head_dim=d_model // n_heads,
            d_ff=d_ff,
            vocab_size=vocab,
            period=_DENSE,
            rope_theta=theta,
            qk_norm=qk_norm,
            shape_skips={"long_500k": "pure full-attention arch (per spec)"},
        )
    )


LLAMA2_7B = _dense("llama2-7b", 32, 4096, 32, 32, 11008, 32000)
LLAMA2_13B = _dense("llama2-13b", 40, 5120, 40, 40, 13824, 32000)
LLAMA2_30B = _dense("llama2-30b", 60, 6656, 52, 52, 17920, 32000)
LLAMA2_70B = _dense("llama2-70b", 80, 8192, 64, 8, 28672, 32000)
QWEN25_7B = _dense("qwen2.5-7b", 28, 3584, 28, 4, 18944, 152064, theta=1e6)
QWEN25_14B = _dense("qwen2.5-14b", 48, 5120, 40, 8, 13824, 152064, theta=1e6)
QWEN25_32B = _dense("qwen2.5-32b", 64, 5120, 40, 8, 27648, 152064, theta=1e6)
QWEN25_72B = _dense("qwen2.5-72b", 80, 8192, 64, 8, 29568, 152064, theta=1e6)

# (TP, DP, PP) settings from Table 3, keyed by paper scale name.
PAPER_PARALLELISM = {
    "small": {"tp": 4, "dp": 2, "pp": 2, "gpus": 16},
    "medium": {"tp": 4, "dp": 2, "pp": 4, "gpus": 32},
    "large": {"tp": 4, "dp": 2, "pp": 8, "gpus": 64},
    "xlarge": {"tp": 4, "dp": 4, "pp": 16, "gpus": 256},
}
PAPER_MODELS = {
    "small": ("llama2-7b", "qwen2.5-7b"),
    "medium": ("llama2-13b", "qwen2.5-14b"),
    "large": ("llama2-30b", "qwen2.5-32b"),
    "xlarge": ("llama2-70b", "qwen2.5-72b"),
}
