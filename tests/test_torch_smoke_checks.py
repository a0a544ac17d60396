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
