"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM).

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
d_ff=0: xLSTM blocks carry their own up/down projections (no separate FFN).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_m = LayerSpec("mlstm", ffn="none")
_s = LayerSpec("slstm", ffn="none")

CONFIG = register(
    ArchConfig(
        arch_id="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        head_dim=512,
        d_ff=0,
        vocab_size=50304,
        period=(_m, _m, _m, _m, _m, _m, _m, _s),
        shape_skips={},  # linear-time recurrent arch => long_500k runs
    )
)
