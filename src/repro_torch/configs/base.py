"""Architecture / shape / run configuration schema.

Every assigned architecture is a frozen `ArchConfig`; the four assigned input
shapes are `ShapeSpec`s. Configs are pure data — no jax imports — so the
scheduler, simulator, and launcher can all consume them without touching
device state.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period of a model."""

    mixer: str  # 'attn' | 'mamba' | 'mlstm' | 'slstm'
    attn_kind: str = "full"  # 'full' | 'swa'  (only for mixer == 'attn')
    ffn: str = "dense"  # 'dense' | 'moe' | 'none'


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def lowers(self) -> str:
        return "train_step" if self.kind == "train" else "serve_step"


# The four LM shape cells assigned to every architecture.
TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    period: tuple[LayerSpec, ...] = (LayerSpec("attn"),)

    # attention details
    window: int = 4096  # sliding-window width for attn_kind == 'swa'
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple[int, ...]] = None  # qwen2-vl M-RoPE

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert FFN width (d_ff of the expert)
    capacity_factor: float = 1.25

    # Mamba (hybrid / ssm families)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # xLSTM
    xlstm_conv: int = 4
    mlstm_chunk: int = 256  # chunkwise-parallel block length (perf knob)

    # encoder-decoder (audio family)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # decoder length = seq_len // dec_ratio for train/prefill shapes
    dec_ratio: int = 4

    # modality frontend stubs
    vlm: bool = False  # expects fused vision embeddings + M-RoPE positions
    audio: bool = False  # expects precomputed frame embeddings

    # numerics
    vocab_pad_to: int = 256
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # which assigned shapes are skipped (per-spec) and why
    shape_skips: dict = field(default_factory=dict)

    # ---------------------------------------------------------------- derived
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, (
            f"{self.arch_id}: n_layers={self.n_layers} not divisible by "
            f"period={len(self.period)}"
        )
        return self.n_layers // len(self.period)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def layer_spec(self, i: int) -> LayerSpec:
        return self.period[i % len(self.period)]

    def layer_specs(self) -> list[LayerSpec]:
        return [self.layer_spec(i) for i in range(self.n_layers)]

    # -------------------------------------------------------- parameter count
    def _attn_params(self) -> int:
        d, hq, hkv = self.d_model, self.q_dim, self.kv_dim
        return d * hq + 2 * d * hkv + hq * d + (2 * self.head_dim if self.qk_norm else 0)

    def _ffn_params(self, spec: LayerSpec) -> int:
        if spec.ffn == "dense":
            return 3 * self.d_model * self.d_ff  # gated (SwiGLU-style)
        if spec.ffn == "moe":
            per = 3 * self.d_model * self.moe_d_ff
            return self.n_experts * per + self.d_model * self.n_experts  # + router
        return 0

    def _mixer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.mixer == "attn":
            return self._attn_params()
        if spec.mixer == "mamba":
            di, n = self.mamba_d_inner, self.mamba_d_state
            # in_proj (2*di), conv, x_proj (dt+2n), dt_proj, out_proj, A, D
            return (
                d * 2 * di
                + di * self.mamba_d_conv
                + di * (math.ceil(d / 16) + 2 * n)
                + di * math.ceil(d / 16)
                + di * d
                + di * n
                + di
            )
        if spec.mixer == "mlstm":
            di = 2 * d
            dh = di // max(self.n_heads, 1)
            # w_m + w_z + conv + block-diag qkv + i/f gates + groupnorm + w_out
            return (
                2 * d * di
                + di * self.xlstm_conv + di
                + 3 * self.n_heads * dh * dh
                + 2 * di * self.n_heads + 2 * self.n_heads
                + di
                + di * d
            )
        if spec.mixer == "slstm":
            dh = self.d_model // max(self.n_heads, 1)
            # w_g (4 gates) + block-diag recurrence + biases + w_out
            return 4 * d * d + 4 * self.n_heads * dh * dh + 4 * self.n_heads * dh + d * d
        raise ValueError(spec.mixer)

    def param_count(self, *, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count — used for MODEL_FLOPS."""
        total = self.padded_vocab * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.padded_vocab * self.d_model
        norms = 2 * self.d_model  # per layer, + final
        for i in range(self.n_layers):
            spec = self.layer_spec(i)
            total += self._mixer_params(spec) + norms
            if spec.ffn == "moe" and active_only:
                total += 3 * self.d_model * self.moe_d_ff * self.moe_top_k
                total += self.d_model * self.n_experts
            else:
                total += self._ffn_params(spec)
        if self.enc_dec:
            # encoder layers (attn + dense ffn) + cross-attn in decoder
            for _ in range(self.n_enc_layers):
                total += self._attn_params() + 3 * self.d_model * self.d_ff + norms
            total += self.n_layers * self._attn_params()  # cross attention
        total += self.d_model
        return total

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

    def runnable_shapes(self) -> list[ShapeSpec]:
        return [s for s in ALL_SHAPES if s.name not in self.shape_skips]


# ---------------------------------------------------------------- registry
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.arch_id not in _REGISTRY, f"duplicate arch {cfg.arch_id}"
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_arch(arch_id: str) -> ArchConfig:
    # import side-effect registration
    from repro_torch import configs as _  # noqa: F401

    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    from repro_torch import configs as _  # noqa: F401

    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A small same-family config for CPU smoke tests."""
    shrink = dict(
        n_layers=len(cfg.period) * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=32,
        n_experts=4 if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.n_experts else 0,
        moe_d_ff=64 if cfg.n_experts else 0,
        mamba_d_state=8,
        n_enc_layers=2 if cfg.enc_dec else 0,
        vocab_pad_to=64,
        arch_id=cfg.arch_id + "-reduced",
    )
    if cfg.mrope_sections is not None:
        shrink["mrope_sections"] = (2, 3, 3)  # sums to head_dim // 2
    shrink.update(overrides)
    return dataclasses.replace(cfg, **shrink)
