"""Serving under a mesh of more than one rank, on the CPU: spawned gloo
ranks (`torch_dist_helpers`) on (1, 2) and (2, 2) `(data, model)` meshes run
prefill through `build_prefill_step` and 4 greedy decode steps through
`build_serve_step` with DTensor parameters (the port's seeded fp32 init,
placed by the sharding rules) and a decode cache placed by
`launch.specs.cache_shardings`, against the same steps unsharded: prefill
logits and every step's logits to 1e-5 of their largest, every token equal.

Cases: reduced qwen3-8b and qwen3-moe-30b-a3b (capacity factor E / k, so
that no token drops whether the tokens are capped whole or per data
shard) with the cache's slots split over tp (`kv_seq`: each rank writes
and attends its own slots, and the ranks merge their softmax parts by
all-reduces); qwen3-8b with the cache's kv heads split instead
(`decode_kv_seq_shard=False`); and on (2, 2) a batch too small to split
(`shard_batch=False`), whose slots go over both mesh axes. Each case also
checks the cache kept its placement through the steps.
"""
import numpy as np
import pytest

from repro_torch.configs import get_arch, reduced
from repro_torch.data.synth import SyntheticPackedDataset

import torch_dist_helpers as dh

PROMPT, STEPS, MAX_LEN = 24, 4, 32
MOE_OVER = {"capacity_factor": 2.0}  # E / k of the reduced config: nothing drops
CASES = {"qwen3-8b-kv_seq": ("qwen3-8b", {}, {}),
         "qwen3-8b-kv_heads": ("qwen3-8b", {}, {"decode_kv_seq_shard": False}),
         "qwen3-moe-kv_seq": ("qwen3-moe-30b-a3b", MOE_OVER, {}),
         "qwen3-8b-every_axis": ("qwen3-8b", {}, {"shard_batch": False}),
         "qwen3-moe-every_axis": ("qwen3-moe-30b-a3b", MOE_OVER, {"shard_batch": False})}
SHAPES = {(1, 2): [n for n in CASES if "every_axis" not in n], (2, 2): list(CASES)}
# the placements of the first layer's K cache, (data, model), by case and mesh
PLACED = {"kv_seq": {(1, 2): "(Replicate(), Shard(dim=1))", (2, 2): "(Shard(dim=0), Shard(dim=1))"},
          "kv_heads": {(1, 2): "(Replicate(), Shard(dim=2))",
                       (2, 2): "(Shard(dim=0), Shard(dim=2))"},
          "every_axis": {(2, 2): "(Shard(dim=1), Shard(dim=1))"}}


def _prompt(arch, B):
    b = SyntheticPackedDataset(reduced(get_arch(arch)), PROMPT, B, seed=1).batch_at(0)
    return {k: np.asarray(b[k]) for k in ("tokens", "segment_ids", "positions")}


@pytest.fixture(scope="module")
def spawned():
    groups = {}
    for shape, names in SHAPES.items():
        cases = {}
        for name in names:
            arch, over, policy = CASES[name]
            B = 1 if "every_axis" in name else 4
            cases[name] = {"kind": "serve", "arch": arch, "over": over, "policy": policy,
                           "seed": 3, "prompt": _prompt(arch, B), "steps": STEPS,
                           "max_len": MAX_LEN}
        groups[shape] = dh.launch(dh.mesh_cases, shape[0] * shape[1], shape, cases)
    return lambda shape: groups[shape].results(600)[0]


@pytest.mark.parametrize("shape,name", [(s, n) for s, names in SHAPES.items() for n in names])
def test_sharded_serving_matches_unsharded(spawned, shape, name):
    got = spawned(shape)[name]
    plain, sharded = got["plain"], got["sharded"]
    for a, b in [(sharded["prefill"], plain["prefill"])] + list(zip(sharded["logits"],
                                                                    plain["logits"])):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert len(sharded["tokens"]) == STEPS
    for a, b in zip(sharded["tokens"], plain["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert sharded["cache_placements"] == PLACED[name.split("-")[-1]][shape]
    assert plain["cache_placements"] == "None"
