"""Model assembly: init, packed forward and loss, prefill, decode step, cache.

Counterpart of `repro.models.model`: layers whose mixer is attention,
Mamba (`models/ssm.py`), mLSTM or sLSTM (`models/xlstm.py`) and whose FFN
is dense, MoE (`models/moe.py`) or none (an xLSTM block carries its own
projections); decoder-only LMs, the hybrid and recurrent ones among them,
the VLM (vision embeddings in
place of the first tokens' embeddings, M-RoPE positions) and the
encoder-decoder (a non-causal encoder over frame embeddings, then a decoder
whose layers cross-attend to its output). Parameters are a plain dict with
the reference's keys and shapes; `layers` (and the encoder's `enc_layers`)
is a list with one dict per layer (layer j*P + pos is `layers[pos][...][j]`
of the reference's scan layout, P the period; the encoder's period is
`cfg.period[0]` alone). Norm weights and every other one-axis weight are
always float32, and so are the few parameters the reference uses in float32
arithmetic only (`layers.FP32_PARAMS`). The other matrices are
stored in whatever dtype `init_params` was given: serving and the forward
phase keep them in bf16; training keeps float32 masters, as the reference
does, and every use casts them to the compute dtype (`attention`, `mlp`,
`embed_tokens`, `lm_logits`), so both give the same numbers. The reference's
`lax.scan` over layers is a Python loop here, and its `jax.checkpoint` per
layer (`remat`) is `torch.utils.checkpoint`.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attention, attention_axes, init_attention
from repro_torch.models.layers import rms_norm
from repro_torch.models.mlp import init_mlp, mlp, mlp_axes
from repro_torch.models.moe import init_moe, moe_axes, moe_ffn, router_aux_loss
from repro_torch.models.ssm import init_mamba, init_mamba_cache, mamba, mamba_axes
from repro_torch.models.xlstm import (
    init_mlstm,
    init_mlstm_cache,
    init_slstm,
    init_slstm_cache,
    mlstm,
    mlstm_axes,
    slstm,
    slstm_axes,
)
from repro_torch.parallel.sharding import NULL_POLICY, arange_rows_like, mesh_block

MIXER_INIT = {"attn": init_attention, "mamba": init_mamba, "mlstm": init_mlstm,
              "slstm": init_slstm}
MIXER_AXES = {"attn": attention_axes, "mamba": mamba_axes, "mlstm": mlstm_axes,
              "slstm": slstm_axes}
MIXER_FN = {"attn": attention, "mamba": mamba, "mlstm": mlstm, "slstm": slstm}
FFN_INIT = {"dense": init_mlp, "moe": init_moe}
FFN_AXES = {"dense": mlp_axes, "moe": moe_axes}
FFN_FN = {"dense": mlp, "moe": moe_ffn}
NORM_AXES = ("dmodel",)


def _check_spec(spec):
    if spec.mixer not in MIXER_FN or (spec.ffn != "none" and spec.ffn not in FFN_FN):
        raise NotImplementedError(f"layer {spec}: no such mixer or FFN")


# ------------------------------------------------------------------- init
def init_layer(generator, cfg, spec, *, cross=False, dtype=torch.bfloat16, device="cuda"):
    """One layer; with `cross`, a decoder layer's cross-attention block too."""
    _check_spec(spec)
    D = cfg.d_model

    def norm():
        return torch.zeros(D, dtype=torch.float32, device=device)
    p = {"norm1": norm(),
         "mixer": MIXER_INIT[spec.mixer](generator, cfg, dtype=dtype, device=device)}
    if cross:
        p["norm_cross"] = norm()
        p["cross"] = init_attention(generator, cfg, dtype=dtype, device=device)
    if spec.ffn != "none":
        p["norm2"] = norm()
        p["ffn"] = FFN_INIT[spec.ffn](generator, cfg, dtype=dtype, device=device)
    return p


def init_params(cfg, seed=0, *, dtype=torch.bfloat16, device="cuda"):
    """Random weights from `seed`, with the reference's keys, shapes and law
    (normal / sqrt(fan_in), norms zero); an encoder-decoder also has
    `enc_layers` (of spec `cfg.period[0]`, no cross block) and `enc_norm`.
    On `device="meta"` the tree holds shapes and dtypes only, so the
    sharding rules read a full-size model without allocating it."""
    g = None
    if torch.device(device).type != "meta":  # meta tensors take no generator
        g = torch.Generator(device=device)
        g.manual_seed(seed)
    V, D = cfg.padded_vocab, cfg.d_model

    def normal(shape):
        w = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
        return w.mul_(1.0 / math.sqrt(D)).to(dtype)

    params = {
        "embed": normal((V, D)),
        "final_norm": torch.zeros(D, dtype=torch.float32, device=device),
        "layers": [init_layer(g, cfg, cfg.layer_spec(i), cross=cfg.enc_dec, dtype=dtype,
                              device=device) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V))
    if cfg.enc_dec:
        params["enc_layers"] = [init_layer(g, cfg, cfg.period[0], dtype=dtype, device=device)
                                for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = torch.zeros(D, dtype=torch.float32, device=device)
    return params


def layer_axes(cfg, spec, *, cross=False):
    """The logical axes of `init_layer`'s leaves (the reference's `annotate`)."""
    _check_spec(spec)
    ax = {"norm1": NORM_AXES, "mixer": MIXER_AXES[spec.mixer](cfg)}
    if cross:
        ax["norm_cross"] = NORM_AXES
        ax["cross"] = attention_axes(cfg)
    if spec.ffn != "none":
        ax["norm2"] = NORM_AXES
        ax["ffn"] = FFN_AXES[spec.ffn](cfg)
    return ax


def param_axes(cfg):
    """The logical axes of every leaf of `init_params(cfg)`, in its tree."""
    ax = {"embed": ("vocab", "dmodel"), "final_norm": NORM_AXES,
          "layers": [layer_axes(cfg, cfg.layer_spec(i), cross=cfg.enc_dec)
                     for i in range(cfg.n_layers)]}
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("dmodel", "vocab")
    if cfg.enc_dec:
        ax["enc_layers"] = [layer_axes(cfg, cfg.period[0]) for _ in range(cfg.n_enc_layers)]
        ax["enc_norm"] = NORM_AXES
    return ax


# ----------------------------------------------------------------- layers
def apply_layer(cfg, spec, p, x, md, cache=None, policy=NULL_POLICY):
    mix_cache = cache.get("mixer") if cache else None
    h, new_mix = MIXER_FN[spec.mixer](cfg, spec, p["mixer"], rms_norm(x, p["norm1"], cfg.norm_eps),
                                      md, cache=mix_cache, policy=policy)
    x = x + h
    new_cache = {"mixer": new_mix} if new_mix is not None else None
    if "cross" in p:  # a decoder layer over the encoder output md["enc_out"]
        cmd = {**md, "cross_x": md.get("enc_out")}
        h, new_cross = attention(cfg, spec, p["cross"], rms_norm(x, p["norm_cross"], cfg.norm_eps),
                                 cmd, cache=cache.get("cross") if cache else None, policy=policy)
        x = x + h
        if new_cross is not None:  # prefill's K/V, or decode's constant cache
            new_cache = {**(new_cache or {}), "cross": new_cross}
    if spec.ffn != "none":
        x = x + FFN_FN[spec.ffn](cfg, p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps),
                                 policy=policy)
    return policy.constrain(x, "batch", "seq", None), new_cache


def _run_layers(cfg, layers, x, md, caches=None, *, remat=False, period=None,
                policy=NULL_POLICY):
    """Run the layers in order, layer i of spec period[i % P] (`cfg.period`
    by default); returns (x, per-layer caches or None).

    With `remat`, while autograd records, each layer keeps only its input for
    the backward and runs again there (the reference's `jax.checkpoint`).
    """
    remat = remat and caches is None and torch.is_grad_enabled()
    period = period or cfg.period
    new_caches = []
    for i, p in enumerate(layers):
        spec = period[i % len(period)]
        _check_spec(spec)
        if remat:
            x, nc = checkpoint(apply_layer, cfg, spec, p, x, md, None, policy,
                               use_reentrant=False,
                               preserve_rng_state=False)  # no layer draws random numbers
        else:
            x, nc = apply_layer(cfg, spec, p, x, md,
                                cache=caches[i] if caches is not None else None, policy=policy)
        new_caches.append(nc)
    return x, (new_caches if new_caches and new_caches[0] is not None else None)


# ----------------------------------------------------------------- embed
def embed_tokens(cfg, params, tokens, compute_dtype=torch.bfloat16, policy=NULL_POLICY):
    """The token embeddings (B,S,D). Under a mesh each rank looks its tokens
    up in its own rows of the table (vocab split over tp, its FSDP shards
    gathered), 0 for a token outside them, and the ranks' rows are summed
    over tp (out Partial there): neither the table nor its gradient is ever
    whole on a rank, as DTensor's own lookup would make it."""
    if policy.mesh is None:
        return params["embed"][tokens.long()].to(compute_dtype)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    table = policy.gathered(params["embed"])
    mesh, V = policy.mesh, table.shape[0]
    split = [i for i, pl in enumerate(table.placements) if pl == Shard(0)]
    n, block = mesh_block(mesh, split)
    lo, rows = block * (V // n), V // n
    tp = policy.batch_placements(tokens.dim())
    out = [Partial() if i in split else pl for i, pl in enumerate(tp)]
    # the table's gradient from each rank's own tokens: summed where they are split
    grad = [Partial() if isinstance(pl, Replicate) and isinstance(t, Shard) else pl
            for pl, t in zip(table.placements, tp)]

    def local(table, tokens):
        idx = tokens.long() - lo
        mine = (idx >= 0) & (idx < rows)
        return table[idx.clamp(0, rows - 1)] * mine[..., None].to(table.dtype)

    x = local_map(local, out_placements=out, in_placements=(None, tp), device_mesh=mesh,
                  redistribute_inputs=True)(table.to_local(grad_placements=grad), tokens)
    return x.to(compute_dtype).redistribute(mesh, [Replicate() if isinstance(pl, Partial) else pl
                                                   for pl in out])


def lm_logits(cfg, params, x, policy=NULL_POLICY):
    w = policy.gathered(params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return policy.constrain(x @ w.to(x.dtype), "batch", "seq", "vocab")


# ------------------------------------------------------------------ train
def _default_md(batch):
    seg = batch["segment_ids"]
    return {"segment_ids": seg, "positions": batch["positions"],
            "abs_positions": arange_rows_like(seg), "causal": True}


def _encoder_md(cfg, params, batch, compute_dtype, remat, policy=NULL_POLICY):
    """Run the non-causal encoder over the frame embeddings, then `enc_norm`;
    returns the decoder's metadata, which carries the encoder output and
    its ids for the cross-attention. Under a mesh the encoder's input is
    constrained as the decoder's is, as the reference constrains it."""
    enc_x = policy.constrain(batch["frame_embeds"].to(compute_dtype), "batch", "seq", None)
    enc_pos = arange_rows_like(batch["enc_segment_ids"])
    enc_md = {"segment_ids": batch["enc_segment_ids"], "positions": batch["enc_positions"],
              "abs_positions": enc_pos, "causal": False}
    enc_out, _ = _run_layers(cfg, params["enc_layers"], enc_x, enc_md, remat=remat,
                             period=(cfg.period[0],), policy=policy)
    seg = batch["dec_segment_ids"]
    return {"segment_ids": seg, "positions": batch["dec_positions"],
            "abs_positions": arange_rows_like(seg), "causal": True,
            "enc_out": rms_norm(enc_out, params["enc_norm"], cfg.norm_eps),
            "cross_segment_ids": batch["enc_segment_ids"], "cross_positions": enc_pos}


def _hidden(cfg, params, batch, compute_dtype, collect, remat=False, policy=NULL_POLICY):
    if cfg.enc_dec:
        md = _encoder_md(cfg, params, batch, compute_dtype, remat, policy)
        x = embed_tokens(cfg, params, batch["dec_tokens"], compute_dtype, policy)
    else:
        md = _default_md(batch)
        x = embed_tokens(cfg, params, batch["tokens"], compute_dtype, policy)
        if cfg.vlm and "vision_embeds" in batch:  # in place of the first S_vis embeddings
            # (under a mesh after `embed_tokens` has summed its vocab shards
            # over tp: the vision rows are whole on every rank, never summed)
            vis = batch["vision_embeds"].to(compute_dtype)
            x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
    if collect:
        md["collect_state"] = True
    x = policy.constrain(x, "batch", "seq", None)
    return _run_layers(cfg, params["layers"], x, md, remat=remat, policy=policy)


def forward_train(cfg, params, batch, *, remat=True, compute_dtype=torch.bfloat16,
                  policy=NULL_POLICY):
    """Packed forward -> logits (B,S,V), aux. The batch, by family:

    LM:      tokens, segment_ids, positions (B,S);
    VLM:     + vision_embeds (B,S_vis,D) in place of the first S_vis token
             embeddings, positions (B,S,3) for M-RoPE;
    enc-dec: frame_embeds (B,S_enc,D), enc_segment_ids, enc_positions
             (B,S_enc), dec_tokens, dec_segment_ids, dec_positions (B,S_dec);
             the logits are the decoder's.

    Differentiable; `remat` recomputes each layer in the backward. With MoE
    layers, aux["moe_aux"] is `router_aux_loss` of the first MoE layer's
    router (layer `pos` of the first MoE period position: `a[0]` of the
    reference's scan layout) on the final-normed hidden state in fp32, not
    on that layer's input, and without a stop-gradient, so its gradient
    reaches that router and the hidden state: the reference's choice.

    Under a `policy` with a mesh the parameters and the batch are DTensors
    placed by the sharding rules, and the activations are constrained where
    the reference constrains them."""
    x, _ = _hidden(cfg, params, batch, compute_dtype, collect=False, remat=remat, policy=policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    moe = [i for i, spec in enumerate(cfg.period) if spec.ffn == "moe"]
    if moe:  # the reference's choice: the first MoE layer's router on the final-normed x
        aux["moe_aux"] = router_aux_loss(cfg, params["layers"][moe[0]]["ffn"], x.float(), policy)
    return lm_logits(cfg, params, x, policy), aux


def _label_logits(policy, logits, labels):
    """logits (B,S,V) at labels (B,S). Under a mesh each rank reads its own
    rows (`local_map`): DTensor's own gather would first gather every row
    of the batch onto every rank."""
    def pick(logits, labels):
        return logits.gather(-1, labels[..., None])[..., 0]
    if policy.mesh is None:
        return pick(logits, labels)
    from torch.distributed.tensor.experimental import local_map

    rows = policy.placements_for(("batch", "seq"), tuple(labels.shape))
    return local_map(pick, out_placements=rows, in_placements=(
        policy.placements_for(("batch", "seq", None), tuple(logits.shape)), rows),
        device_mesh=policy.mesh, redistribute_inputs=True)(logits, labels)


def loss_fn(cfg, params, batch, **fw_kwargs):
    """NLL over labels >= 0 plus 1e-4 z-loss -> (total, metrics)."""
    logits, aux = forward_train(cfg, params, batch, **fw_kwargs)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels_c = labels.clamp_min(0).long()
    # whole rows of logits on every rank of a mesh: the gather reads them
    policy = fw_kwargs.get("policy", NULL_POLICY)
    logits = policy.constrain(logits.float(), "batch", "seq", None)
    lse = torch.logsumexp(logits, dim=-1)
    ll = _label_logits(policy, logits, labels_c)
    nll = (lse - ll) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    zloss = 1e-4 * (lse.square() * mask).sum() / denom
    total = loss + zloss + 0.01 * aux["moe_aux"]
    return total, {"loss": loss, "zloss": zloss, "moe_aux": aux["moe_aux"], "ntokens": mask.sum()}


def prefill_forward(cfg, params, batch, *, compute_dtype=torch.bfloat16, policy=NULL_POLICY):
    """Inference prefill: last-position logits (B,1,V) + per-layer K/V caches
    of length S (an encoder-decoder's also hold each layer's cross K/V over
    the encoder output, under "cross"). Only the last position goes through
    the LM head. Under a `policy` with a mesh the parameters and the batch
    are DTensors, as in `forward_train`, and so are the caches."""
    x, caches = _hidden(cfg, params, batch, compute_dtype, collect=True, policy=policy)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x, policy), caches


# ----------------------------------------------------------------- decode
def cache_len(cfg, spec, max_len):
    """Slots of a layer's decode cache: max_len for full attention; a ring of
    min(2 * window, max_len) for a sliding-window layer (the reference's
    `_layer_cache`), written at slot position % T."""
    return min(2 * cfg.window, max_len) if spec.attn_kind == "swa" else max_len


def _layer_cache(cfg, spec, B, max_len, cache_dtype, device, cross_len):
    """One layer's zero decode cache (the reference's `_layer_cache`)."""
    K, dh = cfg.n_kv_heads, cfg.head_dim

    def zeros(T):
        return torch.zeros((B, T, K, dh), dtype=cache_dtype, device=device)
    _check_spec(spec)
    if spec.mixer == "attn":
        T = cache_len(cfg, spec, max_len)
        c = {"mixer": {"k": zeros(T), "v": zeros(T),
                       "pos": torch.full((B, T), -1, dtype=torch.int32, device=device)}}
    elif spec.mixer == "mamba":  # float32 conv window, the reference's default
        c = {"mixer": init_mamba_cache(cfg, B, device=device)}
    elif spec.mixer == "mlstm":
        c = {"mixer": init_mlstm_cache(cfg, B, device=device)}
    else:
        c = {"mixer": init_slstm_cache(cfg, B, device=device)}
    if cfg.enc_dec:
        c["cross"] = {"k_const": zeros(cross_len), "v_const": zeros(cross_len)}
    return c


def init_cache(cfg, B, max_len, cache_dtype=torch.bfloat16, device="cuda", cross_len=0):
    """Per-layer decode cache, by mixer: attention's zero K/V of `cache_len`
    slots, positions -1; Mamba's zero float32 conv window (B, K-1, d_inner)
    and state (B, d_inner, N); the mLSTM's zero (C, n, m) and the sLSTM's
    (c, n, m, h), float32. An encoder-decoder's layers also hold zero cross
    K/V of `cross_len` encoder positions ("cross": {"k_const", "v_const"})."""
    return [_layer_cache(cfg, cfg.layer_spec(i), B, max_len, cache_dtype, device, cross_len)
            for i in range(cfg.n_layers)]


def extend_cache(cfg, prefill_caches, max_len):
    """A max_len decode cache from the prefill's: an attention layer's K/V
    of position p in slot p of a full layer, p % T of a sliding-window
    layer's ring, of which it keeps the last T positions (the ones decode
    can still see); a recurrent layer's state, and an encoder-decoder's
    cross K/V, carried over unchanged. B, the prompt length S, the dtype
    and the device are the first K/V's (B, device of any state without
    attention)."""
    kv = [c["mixer"]["k"] for c in prefill_caches if "k" in c["mixer"]]
    first = kv[0] if kv else next(iter(prefill_caches[0]["mixer"].values()))
    B, S = first.shape[0], (kv[0].shape[1] if kv else 0)
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    cache = []
    for i, src in enumerate(prefill_caches):
        spec = cfg.layer_spec(i)
        if spec.mixer != "attn":
            cache.append(dict(src))
            continue
        dst = _layer_cache(cfg, spec, B, max_len, first.dtype, first.device, 0)
        T = dst["mixer"]["k"].shape[1]
        keep = min(S, T)
        slots = torch.arange(S - keep, S, device=first.device) % T
        for name in ("k", "v", "pos"):
            dst["mixer"][name][:, slots] = src["mixer"][name][:, S - keep:]
        if "cross" in src:
            dst["cross"] = src["cross"]
        cache.append(dst)
    return cache


def serve_forward(cfg, params, cache, batch, *, compute_dtype=torch.bfloat16,
                  policy=NULL_POLICY):
    """One decode step. batch: tokens (B,1), lengths (B,) current positions;
    an encoder-decoder's also cross_segment_ids and cross_positions (B,S_enc),
    the ids of its cross caches' encoder positions. With M-RoPE the step's
    position is `lengths` on all three axes, as the reference's.
    Under a `policy` with a mesh the parameters, the cache (placed by
    `launch.specs.cache_shardings`) and the batch are DTensors.

    Returns (logits (B,1,V), cache), the cache updated in place.
    """
    tokens, lengths = batch["tokens"], batch["lengths"]
    B = tokens.shape[0]
    positions = lengths[:, None].to(torch.int32)
    if cfg.mrope_sections is not None:
        positions = positions[..., None].expand(B, 1, 3)
    md = {
        "positions": positions,
        "lengths": lengths,
        "segment_ids": torch.ones((B, 1), dtype=torch.int32, device=tokens.device),
        "causal": True,
    }
    if cfg.enc_dec:
        md["cross_segment_ids"] = batch["cross_segment_ids"]
        md["cross_positions"] = batch["cross_positions"]
    x = policy.constrain(embed_tokens(cfg, params, tokens, compute_dtype, policy), "batch", None,
                         None)
    x, cache = _run_layers(cfg, params["layers"], x, md, caches=cache, policy=policy)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(cfg, params, x, policy), cache
