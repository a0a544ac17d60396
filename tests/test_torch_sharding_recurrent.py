"""The recurrent families under a mesh on the CPU: spawned gloo ranks
(`torch_dist_helpers`, one group a mesh shape running all of that shape's
cases) against the port's unsharded steps and the JAX package.

  * models: reduced xlstm-1.3b cut to one mLSTM and one sLSTM layer (chunks
    of 16 positions), at 4 heads (the inner width 128 and the heads divide
    tp 2) and at 3 heads (d_model 48: the inner width 96 divides tp 2, the
    heads do not, so every rank runs every head); reduced
    jamba-1.5-large-398b cut to its Mamba + MoE layer and its attention
    layer (d_inner 128; capacity factor E / k, which drops no token, since
    under a mesh each data shard's tokens are capped alone);
  * train step: weights from one JAX `stacked_init` (`bridge.params_from_jax`),
    2 fp32 AdamW steps of 2 micro-batches on (2,1), (1,2) and (2,2)
    `(data, model)` meshes: the losses to 1e-5 of the port's unsharded
    step, the step-0 gradients to 1e-5 of each leaf's max, and step 0's
    loss to 1e-4 of the JAX `loss_fn` (the mean over the micro-batches,
    computing in fp32);
  * serving: prefill through `build_prefill_step` and 4 greedy decode steps
    through `build_serve_step` with DTensor parameters (the port's seeded
    fp32 init) and a cache placed by `launch.specs.cache_shardings`,
    against the same steps unsharded (logits to 1e-5 of their largest,
    every token equal), on (1,2) and (2,2): Mamba's state split over d_inner
    and the mLSTM's and sLSTM's over heads where tp divides them;
  * each scan (`ssm.selective_scan`, `xlstm.mlstm_scan`, `xlstm.slstm_scan`)
    receives plain tensors, never DTensors: it runs on local shards.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.data.synth import SyntheticPackedDataset
from repro.models.model import loss_fn as j_loss_fn, stacked_init
from repro.parallel.sharding import NULL_POLICY as J_NULL, split_annotations
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced

import torch_dist_helpers as dh
from test_torch_sharding_families import _port_steps

STEPS, MICROBATCHES = 2, 2
B, S = 4, 64
# name: (arch, period positions kept, config overrides)
MODELS = {"xlstm": ("xlstm-1.3b", (0, 7), {"mlstm_chunk": 16}),
          "xlstm-3heads": ("xlstm-1.3b", (0, 7), {"mlstm_chunk": 16, "d_model": 48,
                                                   "n_heads": 3, "n_kv_heads": 3}),
          # capacity E / k: no token dropped, so that the MoE layer's split of
          # the tokens over data (each shard capped alone) is the unsharded layer
          "jamba": ("jamba-1.5-large-398b", (0, 3), {"capacity_factor": 2.0})}
TRAIN_SHAPES = [(2, 1), (1, 2), (2, 2)]
TRAIN_CASES = [(s, m) for s in TRAIN_SHAPES for m in MODELS]
SERVE_SHAPES = [(1, 2), (2, 2)]
SERVE_MODELS = ("xlstm", "xlstm-3heads", "jamba")
SERVE_CASES = [(s, m) for s in SERVE_SHAPES for m in SERVE_MODELS]
PROMPT, SERVE_STEPS = 32, 4  # two mLSTM chunks
# the placements of the first layer's first cache leaf, (data, model), by mesh
PLACED = {("xlstm", (1, 2)): "(Replicate(), Shard(dim=1))",
          ("xlstm", (2, 2)): "(Shard(dim=0), Shard(dim=1))",
          ("xlstm-3heads", (1, 2)): "(Replicate(), Replicate())",
          ("xlstm-3heads", (2, 2)): "(Shard(dim=0), Replicate())",
          ("jamba", (1, 2)): "(Replicate(), Shard(dim=2))",
          ("jamba", (2, 2)): "(Shard(dim=0), Shard(dim=2))"}
SCANS = {"xlstm": {"mlstm_scan", "slstm_scan"}, "jamba": {"selective_scan"}}


def _over(model, specs):
    arch, keep, over = MODELS[model]
    period = tuple(specs[i] for i in keep)
    return {**over, "period": period, "n_layers": len(period)}


def _t_cfg(model):
    return t_reduced(t_get_arch(MODELS[model][0]), **_over(model, t_get_arch(
        MODELS[model][0]).period))


@functools.lru_cache(maxsize=None)
def _model(model):
    """The JAX config, `stacked_init` weights (numpy) and STEPS training
    batches (jamba's: each row's padding filled with a document, as
    test_torch_recurrent's, so that no row pads with the mean of V)."""
    arch = MODELS[model][0]
    cfg = reduced(get_arch(arch), **_over(model, get_arch(arch).period))
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(3), cfg))
    data = SyntheticPackedDataset(cfg, S, B, seed=5, mu=3.2, sigma=0.8)
    batches = [data.batch_at(i) for i in range(STEPS)]
    for b in batches if cfg.n_experts else ():
        seg, pos = b["segment_ids"], b["positions"]
        for r in range(B):
            pad = seg[r] == 0
            seg[r, pad] = seg[r].max() + 1
            pos[r, pad] = np.arange(int(pad.sum()))
    return cfg, jax.tree.map(np.asarray, params), batches


def _step_case(model):
    _, params, batches = _model(model)
    return {"kind": "step", "arch": MODELS[model][0], "over": _over(model, t_get_arch(
        MODELS[model][0]).period), "policy": {}, "opt": ("adamw", "float32"), "params": params,
        "batches": batches, "lr": 1e-3, "microbatches": MICROBATCHES, "clip_norm": 1.0}


def _prompt(model):
    cfg = _t_cfg(model)
    rng = np.random.default_rng(9)
    return {"tokens": rng.integers(1, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32),
            "segment_ids": np.ones((B, PROMPT), np.int32),
            "positions": np.tile(np.arange(PROMPT, dtype=np.int32), (B, 1))}


def _cases(shape):
    cases = {f"train-{m}": _step_case(m) for m in MODELS}
    if shape in SERVE_SHAPES:
        for m in SERVE_MODELS:
            cases[f"serve-{m}"] = {"kind": "serve", "arch": MODELS[m][0], "policy": {},
                                   "over": _over(m, t_get_arch(MODELS[m][0]).period), "seed": 3,
                                   "prompt": _prompt(m), "steps": SERVE_STEPS, "max_len": None}
    if shape == (2, 2):
        for m in ("xlstm", "jamba"):
            cases[f"types-{m}"] = {"kind": "local_types", "arch": MODELS[m][0], "policy": {},
                                   "over": _over(m, t_get_arch(MODELS[m][0]).period),
                                   "batch": {k: v[:2] for k, v in _model(m)[2][0].items()}}
    return cases


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """Every spawned group, started at once when the module's first test
    runs (they run beside the references); `get(shape)` joins one."""
    groups = {shape: dh.launch(dh.mesh_cases, shape[0] * shape[1], shape, _cases(shape))
              for shape in TRAIN_SHAPES}

    def get(shape):
        return groups[shape].results(600)
    yield get
    for g in groups.values():
        try:
            g.results(timeout=30)
        except RuntimeError:
            pass


@functools.lru_cache(maxsize=None)
def _reference(model):
    """The port's unsharded run and the JAX `loss_fn` on step 0 (the mean
    loss over the micro-batches)."""
    cfg, params, batches = _model(model)
    port = _port_steps(_t_cfg(model), params, batches)
    jp = jax.tree.map(jnp.asarray, params)
    loss = jax.jit(lambda p, b: j_loss_fn(cfg, p, b, J_NULL, compute_dtype=jnp.float32)[0])
    n = B // MICROBATCHES
    parts = [float(loss(jp, {k: jnp.asarray(v[i * n:(i + 1) * n]) for k, v in batches[0].items()}))
             for i in range(MICROBATCHES)]
    return port, sum(parts) / MICROBATCHES


@pytest.mark.parametrize("shape,model", TRAIN_CASES,
                         ids=[f"{s[0]}x{s[1]}-{m}" for s, m in TRAIN_CASES])
def test_sharded_recurrent_step_matches_unsharded_and_jax(shape, model, spawned):
    got = spawned(shape)[0][f"train-{model}"]
    port, jax_loss = _reference(model)
    np.testing.assert_allclose(got["loss"], port["loss"], rtol=1e-5)
    assert got["step"] == STEPS
    for i, (a, b) in enumerate(zip(got["grads"][0], port["grads"][0], strict=True)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max() + 1e-12, i
    np.testing.assert_allclose(got["loss"][0], jax_loss, rtol=1e-4)


@pytest.mark.parametrize("shape,model", SERVE_CASES,
                         ids=[f"{s[0]}x{s[1]}-{m}" for s, m in SERVE_CASES])
def test_sharded_recurrent_serving_matches_unsharded(shape, model, spawned):
    got = spawned(shape)[0][f"serve-{model}"]
    plain, sharded = got["plain"], got["sharded"]
    for a, b in [(sharded["prefill"], plain["prefill"])] + list(zip(sharded["logits"],
                                                                    plain["logits"])):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert len(sharded["tokens"]) == SERVE_STEPS
    for a, b in zip(sharded["tokens"], plain["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert sharded["cache_placements"] == PLACED[model, shape]
    assert plain["cache_placements"] == "None"


@pytest.mark.parametrize("model", ["xlstm", "jamba"])
def test_each_scan_runs_on_local_tensors(model, spawned):
    """On (2, 2) every scan of the model's mixers was called, with plain
    tensors only, on every rank's shards."""
    got = spawned((2, 2))[0][f"types-{model}"]
    assert set(got) == SCANS[model]
    assert all(types == ["Tensor"] for types in got.values()), got
