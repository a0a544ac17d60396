"""Per-architecture smoke tests of the port, the torch counterpart of
`tests/test_models_smoke.py`'s three sweeps, over every arch of
`repro_torch.configs.ASSIGNED_ARCHS` on the CPU: a reduced same-family
config (the fewest layers that hold every distinct layer spec of the arch's
period), one packed forward (shapes, finite logits), one train step (finite
loss, gradient norm above 0) and one bf16 decode step from an empty cache
(finite logits, some cache leaf changed); and the training driver on
the recurrent families. Imports no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_arch, reduced
from repro_torch.data.synth import SyntheticPackedDataset
from repro_torch.models.model import forward_train, init_cache, init_params, serve_forward
from repro_torch.train.optimizer import make_optimizer, tree_leaves
from repro_torch.train.train_step import build_train_step, init_train_state

B, S = 2, 64
CPU = torch.device("cpu")


def _smoke_cfg(arch_id):
    """Reduced config with the fewest layers that still hold every distinct
    LayerSpec of the arch's period, the period cut to that prefix (as the
    reference's sweep cuts it)."""
    arch = get_arch(arch_id)
    seen, prefix = set(), 0
    for i, spec in enumerate(arch.period):
        if spec not in seen:
            seen.add(spec)
            prefix = i + 1
    over = {"n_layers": max(2, prefix)}
    if prefix < len(arch.period):
        over["period"] = arch.period[:prefix]
    return reduced(arch, **over)


def _batch(cfg, seed=0):
    batch = SyntheticPackedDataset(cfg, S, B, seed=seed).batch_at(0)
    rng = np.random.default_rng(seed)
    if cfg.enc_dec:
        Sd = max(S // cfg.dec_ratio, 16)
        batch = {
            "frame_embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
            "enc_segment_ids": np.ones((B, S), np.int32),
            "enc_positions": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
            "dec_tokens": rng.integers(1, cfg.vocab_size, size=(B, Sd)).astype(np.int32),
            "dec_segment_ids": np.ones((B, Sd), np.int32),
            "dec_positions": np.tile(np.arange(Sd, dtype=np.int32), (B, 1)),
            "labels": rng.integers(0, cfg.vocab_size, size=(B, Sd)).astype(np.int32),
        }
    elif cfg.vlm:
        batch["vision_embeds"] = np.zeros((B, S // 4, cfg.d_model), np.float32)
        batch["positions"] = np.repeat(batch["positions"][..., None], 3, -1)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_sweep_covers_every_assigned_arch_and_mixer():
    assert len(ASSIGNED_ARCHS) == 10
    mixers = {spec.mixer for a in ASSIGNED_ARCHS for spec in _smoke_cfg(a).period}
    ffns = {spec.ffn for a in ASSIGNED_ARCHS for spec in _smoke_cfg(a).period}
    assert mixers == {"attn", "mamba", "mlstm", "slstm"} and ffns == {"dense", "moe", "none"}


@pytest.mark.parametrize("arch_id", ASSIGNED_ARCHS)
def test_forward_shapes_finite(arch_id):
    cfg = _smoke_cfg(arch_id)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=CPU)
    batch = _batch(cfg)
    with torch.no_grad():
        logits, aux = forward_train(cfg, params, batch, remat=False)
    S_out = batch["dec_tokens"].shape[1] if cfg.enc_dec else S
    assert logits.shape == (B, S_out, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(aux["moe_aux"]))


@pytest.mark.parametrize("arch_id", ASSIGNED_ARCHS)
def test_train_step_no_nan(arch_id):
    cfg = _smoke_cfg(arch_id)
    opt = make_optimizer("adamw", lr=1e-3)
    state = init_train_state(0, cfg, opt, device=CPU)
    step = build_train_step(cfg, opt, microbatches=1, remat=False)
    state, metrics = step(state, _batch(cfg))
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert int(state["step"]) == 1


@pytest.mark.parametrize("arch_id", ASSIGNED_ARCHS)
def test_decode_step(arch_id):
    cfg = _smoke_cfg(arch_id)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=CPU)
    cache = init_cache(cfg, B, 64, device=CPU, cross_len=S if cfg.enc_dec else 0)
    before = [x.clone() for x in tree_leaves(cache)]
    batch = {"tokens": torch.ones((B, 1), dtype=torch.int32),
             "lengths": torch.tensor([3, 7], dtype=torch.int32)}
    if cfg.enc_dec:
        batch["cross_segment_ids"] = torch.ones((B, S), dtype=torch.int32)
        batch["cross_positions"] = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    with torch.no_grad():
        logits, new_cache = serve_forward(cfg, params, cache, batch)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    after = tree_leaves(new_cache)
    assert len(after) == len(before)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("arch_id,mode", [("xlstm-1.3b", "spmd"),
                                          ("jamba-1.5-large-398b", "spmd"),
                                          ("xlstm-1.3b", "pipeline")])
def test_driver_trains_the_recurrent_families(arch_id, mode):
    """The training driver feeds the recurrent families token batches, as
    the reference's does: reduced xlstm-1.3b and jamba-1.5-large-398b
    through `run_spmd`, and xlstm-1.3b's layers through the pipeline engine
    at dp1/pp2; finite losses."""
    from repro_torch.launch import train as driver

    argv = ["--reduced", "--arch", arch_id, "--steps", "2", "--seq-len", "64", "--batch", "2",
            "--device", "cpu"]
    if mode == "pipeline":
        argv += ["--mode", "pipeline", "--dp", "1", "--pp", "2"]
    args = driver.parser().parse_args(argv)
    cfg = reduced(get_arch(arch_id), n_layers=len(get_arch(arch_id).period))
    run = driver.run_spmd if mode == "spmd" else driver.run_pipeline
    result = run(cfg, args)
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
