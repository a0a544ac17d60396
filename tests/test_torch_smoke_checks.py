"""`chip_smoke.py`'s MoE serve checks on the CPU, at a reduced size: the
drop-free decode check (`moe_decode_check`) and the main path's first decode
step held to it on the rows its prefill dropped nothing of
(`main_first_check`, `dropped_rows`). The script's prompt length is cut to
32 positions; the weights are fp32 from a seed, the compute bf16 as on the
card, so the script's own tolerances hold. Imports no JAX."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models.model import extend_cache, init_params
from repro_torch.train.train_step import build_prefill_step, build_serve_step

ROOT = Path(__file__).resolve().parents[1]
PROMPT = 32
CPU = torch.device("cpu")


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "PROMPT", PROMPT)
    return cs


def _batch(cfg, B):
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32))
    return {"tokens": tokens, "segment_ids": torch.ones((B, PROMPT), dtype=torch.int32),
            "positions": torch.arange(PROMPT, dtype=torch.int32).repeat(B, 1)}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_moe_serve_checks_hold_on_the_cpu(smoke, arch):
    """The drop-free decode step agrees with the packed forward on at least
    MOE_ROUTE_AGREEMENT_FLOOR of the fed token's routes and within
    TOL_DECODE_REL; a prefill at capacity factor 0.5 drops assignments of
    some rows but never of row 0 (token-major ranks: its assignments fill at
    most PROMPT slots of an expert, and C = PROMPT·B·k·0.5/E = PROMPT), so
    `main_first_check` holds exactly the rows without a drop, and there
    within TOL_DECODE_REL."""
    cfg = reduced(get_arch(arch), n_layers=2)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=CPU)
    B = smoke.SERVE_B
    batch = _batch(cfg, B)
    with torch.no_grad():
        check, nodrop_first = smoke.moe_decode_check(cfg, params, batch, CPU)
        assert check["route_agreement"] >= smoke.MOE_ROUTE_AGREEMENT_FLOOR
        assert check["decode_rel_err"] <= smoke.TOL_DECODE_REL

        tight = dataclasses.replace(cfg, capacity_factor=0.5)
        routes = {}
        with smoke.recording_routes(routes, "prefill"):
            last, caches = build_prefill_step(tight)(params, batch)
        cache = extend_cache(tight, caches, PROMPT + 1)
        tok = last[:, -1].argmax(-1).to(torch.int32)
        lengths = torch.full((B,), PROMPT, dtype=torch.int32)
        first = build_serve_step(tight)(params, cache, {"tokens": tok[:, None],
                                                        "lengths": lengths})[1][:, 0]
    dropped = [any(bool((~r["kept"][b]).any()) for r in routes["prefill"]) for b in range(B)]
    assert not dropped[0] and any(dropped)
    assert smoke.dropped_rows(routes["prefill"]).tolist() == dropped
    res = smoke.main_first_check(first, nodrop_first, routes["prefill"])
    assert res["main_first_rows_held"] == dropped.count(False)
    assert res["main_first_held"] and res["main_first_rel_err"] <= smoke.TOL_DECODE_REL


def test_parity_model_keeps_the_real_mrope_sections(smoke):
    """The fp32 parity path of qwen2-vl-7b keeps the real head width and
    its M-RoPE sections (16, 24, 24), which sum to head_dim // 2 = 64
    (`reduced`'s (2, 3, 3) fit head_dim 16 only), and its model runs on its
    own batch: 3-axis positions, a vision span of PARITY_SEQ / 8 a row."""
    from repro_torch.models.model import forward_train

    small, batch = smoke.parity_model(get_arch("qwen2-vl-7b"))
    assert small.head_dim == 128 and small.mrope_sections == (16, 24, 24)
    assert batch["positions"].shape == (smoke.PARITY_BATCH, smoke.PARITY_SEQ, 3)
    params = init_params(small, seed=0, dtype=torch.float32, device=CPU)
    with torch.no_grad():
        logits, _ = forward_train(small, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  compute_dtype=torch.float32)
    assert logits.shape[:2] == (smoke.PARITY_BATCH, smoke.PARITY_SEQ)
    assert bool(torch.isfinite(logits).all())


def test_decode_bound_reads_the_decoder_and_every_cache(smoke):
    """A decode step never runs the encoder: whisper's weight bytes are the
    decoder's (the embedding's batch rows only, the LM head whole), and
    the cache bytes hold the constant cross K/V besides the self caches."""
    from repro_torch.models.model import init_cache
    from repro_torch.train.optimizer import tree_leaves

    cfg = reduced(get_arch("whisper-medium"))
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=CPU)
    cache = init_cache(cfg, smoke.SERVE_B, 16, device=CPU, cross_len=40)
    got = smoke.decode_bound(cfg, params, cache)
    decoder = sum(x.numel() * 2 for k in ("layers", "final_norm", "lm_head")
                  for x in tree_leaves(params[k]) if x.dtype == torch.bfloat16)
    decoder += sum(x.numel() * 4 for k in ("layers", "final_norm")
                   for x in tree_leaves(params[k]) if x.dtype == torch.float32)
    decoder += smoke.SERVE_B * cfg.d_model * 2  # the fed tokens' embedding rows
    assert got["weight_bytes"] == decoder
    cross = sum(c["cross"][k].numel() * 2 for c in cache for k in ("k_const", "v_const"))
    assert cross > 0 and got["cache_bytes"] == smoke.nbytes(*tree_leaves(cache))


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_decode_bound_reads_and_writes_recurrent_state(smoke, arch):
    """A decode step replaces every recurrent state (an mLSTM's C, n, m, an
    sLSTM's c, n, m, h, Mamba's conv window and state): `decode_bound`
    counts those bytes twice, read and written, and attention K/V once
    (reduced configs; xlstm-1.3b holds no attention cache)."""
    from repro_torch.models.model import init_cache
    from repro_torch.train.optimizer import tree_leaves

    cfg = reduced(get_arch(arch))
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=CPU)
    cache = init_cache(cfg, smoke.SERVE_B, 16, device=CPU)
    got = smoke.decode_bound(cfg, params, cache)
    states = smoke.nbytes(*(x for c in cache if "k" not in c["mixer"]
                            for x in c["mixer"].values()))
    kv = smoke.nbytes(*tree_leaves(cache)) - states
    assert states > 0 and got["state_bytes"] == states and got["cache_bytes"] == kv
    assert (kv > 0) == arch.startswith("jamba")
    assert got["bound_ms"] == pytest.approx(
        (got["weight_bytes"] + kv + 2 * states) / smoke.PEAK_BYTES * 1e3, rel=1e-12)


def test_full_xlstm_state_bytes():
    """xlstm-1.3b's decode state at the serve batch (meta tensors, no
    memory): 42 mLSTM layers of C (4, 4, 1024, 1024), n and m and 6 sLSTM
    layers of c, n, m, h (4, 4, 512), all float32: 2.82 GB, moved twice a
    step."""
    from repro_torch.models.model import init_cache

    cfg = get_arch("xlstm-1.3b")
    cache = init_cache(cfg, 4, 2112, device="meta")
    got = sum(x.numel() * x.element_size() for c in cache for x in c["mixer"].values())
    B, H = 4, cfg.n_heads
    dh_m, dh_s = 2 * cfg.d_model // H, cfg.d_model // H
    assert got == 4 * (42 * B * H * (dh_m * dh_m + dh_m + 1) + 6 * 4 * B * H * dh_s)
    assert 2.8e9 < got < 2.85e9
