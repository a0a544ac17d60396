"""whisper-medium [audio] — enc-dec transformer backbone; conv frontend stub.

24L (encoder and decoder each) d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=51865 [arXiv:2212.04356; unverified]. The conv frontend is a stub per
the assignment: input_specs() provides precomputed frame embeddings for the
encoder. Train/prefill shapes drive the encoder at seq_len frames with a
seq_len//4 decoder; decode shapes drive the decoder with a seq_len KV cache
cross-attending seq_len encoder frames. vocab 51865 is padded to 51968 (x256)
for clean TP sharding.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(
    ArchConfig(
        arch_id="whisper-medium",
        family="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        period=(LayerSpec("attn", attn_kind="full", ffn="dense"),),
        enc_dec=True,
        n_enc_layers=24,
        dec_ratio=4,
        audio=True,
        rope_theta=10000.0,  # backbone uses rope in lieu of learned-pos (stub-adapted)
        shape_skips={
            "long_500k": "pure full-attention enc-dec arch; sub-quadratic required (per spec)"
        },
    )
)
