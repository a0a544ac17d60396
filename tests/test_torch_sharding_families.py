"""The VLM and encoder-decoder families under a mesh, and MoE tokens over
two data axes, on the CPU: spawned gloo ranks (`torch_dist_helpers`, one
group a mesh shape running all of that shape's cases) against the port's
unsharded steps and the JAX package.

  * train step: reduced qwen2-vl-7b (M-RoPE sections (2, 3, 3), vision
    embeddings in place of each row's first 8 token embeddings) and
    reduced whisper-medium (2 encoder and 2 decoder layers, cross-attention
    over the non-causal encoder's output), weights from one JAX
    `stacked_init`, batches from `data.multimodal`, 2 fp32 AdamW steps of 2
    micro-batches on (2,1), (1,2) and (2,2) `(data, model)` meshes: the
    losses to 1e-5 of the port's unsharded step, the step-0 gradients to
    1e-5 of each leaf's max, the final parameters to the unsharded
    optimizer replayed on the sharded gradients (1e-5) and to the unsharded
    run (1e-5 of the leaf's max plus 1e-3 lr, but for at most 1%), and
    step 0's loss and grad norm to 1e-4 of the JAX `loss_fn` (the mean of
    `jax.value_and_grad` over the micro-batches, computing in fp32). At
    tp 2 a witness shows that vision rows summed over tp would fail the
    check: the same step with the vision embeddings doubled moves the loss
    far past 1e-5;
  * serving: prefill through `build_prefill_step` and 4 greedy decode
    steps through `build_serve_step` with DTensor parameters (the port's
    seeded fp32 init) and a cache placed by `launch.specs.cache_shardings`,
    against the same steps unsharded (logits to 1e-5 of their largest,
    every token equal), on (1,2) and (2,2): the decode cache and the
    encoder-decoder's constant cross cache split on their slots (`kv_seq`:
    each rank attends its own encoder positions, the ranks' softmax parts
    merged by all-reduces), on kv heads, and over both axes for a batch of
    one;
  * MoE over two data axes: reduced qwen3-moe-30b-a3b on a (2, 2, 1)
    ("pod", "data", "model") mesh, the EP and the per-expert TP variant, 2
    steps against the port's unsharded step whose MoE layer caps each of
    the 4 (pod, data) shards' tokens alone, pod-major, as the reference's
    shard_map over P(("pod", "data"), None, None) does; every rank's
    routes and drops of the first step equal the unsharded step's on its
    shard.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.data.synth import SyntheticPackedDataset
from repro.models.model import loss_fn as j_loss_fn, stacked_init
from repro.parallel.sharding import NULL_POLICY as J_NULL, split_annotations
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.data.multimodal import enc_dec_batch, mrope_positions, vlm_batch
from repro_torch.models import model as t_model, moe
from repro_torch.parallel.sharding import NULL_POLICY
from repro_torch.train.optimizer import make_optimizer, tree_leaves, tree_map
from repro_torch.train.train_step import build_train_step

import torch_dist_helpers as dh

LR, STEPS, MICROBATCHES = 1e-3, 2, 2
FAMILIES = ("qwen2-vl-7b", "whisper-medium")
B, S, VIS, GRID = 4, 64, 8, (2, 4)      # the VLM's training rows and vision span
FRAMES, DEC, CLIPS = 96, 24, (20, 40)   # the encoder-decoder's
TRAIN_SHAPES = [(2, 1), (1, 2), (2, 2)]
TRAIN_CASES = [(s, a) for s in TRAIN_SHAPES for a in FAMILIES]

PROMPT, SERVE_STEPS, MAX_LEN = 24, 4, 32
# name: (arch, policy keywords, rows); the placements of the first layer's
# K cache and (whisper) cross K cache, (data, model), by mesh
SERVE = {"qwen2-vl-7b-kv_seq": ("qwen2-vl-7b", {}, 4),
         "whisper-medium-kv_seq": ("whisper-medium", {}, 4),
         "whisper-medium-kv_heads": ("whisper-medium", {"decode_kv_seq_shard": False}, 4),
         "whisper-medium-every_axis": ("whisper-medium", {"shard_batch": False}, 1)}
SERVE_SHAPES = {(1, 2): ["qwen2-vl-7b-kv_seq", "whisper-medium-kv_seq"], (2, 2): list(SERVE)}
PLACED = {"kv_seq": {(1, 2): "(Replicate(), Shard(dim=1))", (2, 2): "(Shard(dim=0), Shard(dim=1))"},
          "kv_heads": {(2, 2): "(Shard(dim=0), Shard(dim=2))"},
          "every_axis": {(2, 2): "(Shard(dim=1), Shard(dim=1))"}}
SERVE_CASES = [(s, n) for s, names in SERVE_SHAPES.items() for n in names]

POD_SHAPE, POD_AXES = (2, 2, 1), ("pod", "data", "model")
POD_SHARDS = 4  # (pod, data) blocks of the batch, pod-major
MOE = "qwen3-moe-30b-a3b"
MOE_OVER = {"capacity_factor": 1.0}  # 32 slots an expert for a shard's 64 x 2 assignments
MOE_ROWS = 8  # 2 micro-batches of 4 rows: one a (pod, data) shard
MOE_VARIANTS = {"ep": {"expert_parallel": True}, "tp": {}}


# ------------------------------------------------------------------ inputs
@functools.lru_cache(maxsize=None)
def _family(arch):
    """The JAX config, `stacked_init` weights (numpy) and STEPS training
    batches of a reduced family model."""
    cfg = reduced(get_arch(arch))
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(7), cfg))
    if cfg.enc_dec:
        batches = [enc_dec_batch(cfg, FRAMES, DEC, B, seed=3, clip_frames=CLIPS, index=i)
                   for i in range(STEPS)]
    else:
        batches = [vlm_batch(cfg, S, B, seed=3, vision_len=VIS, grid=GRID, index=i, mu=3.2,
                             sigma=0.8) for i in range(STEPS)]
    return cfg, jax.tree.map(np.asarray, params), batches


@functools.lru_cache(maxsize=None)
def _moe_inputs():
    cfg = reduced(get_arch(MOE), **MOE_OVER)
    params, _ = split_annotations(stacked_init(jax.random.PRNGKey(5), cfg))
    batches = [SyntheticPackedDataset(cfg, S, MOE_ROWS, seed=11, mu=3.6, sigma=0.8).batch_at(i)
               for i in range(STEPS)]
    return cfg, jax.tree.map(np.asarray, params), batches


def _step_case(arch, params, batches, over=None, policy=None, routes=False):
    return {"kind": "step", "arch": arch, "over": over or {}, "policy": policy or {},
            "opt": ("adamw", "float32"), "params": params, "batches": batches, "lr": LR,
            "microbatches": MICROBATCHES, "clip_norm": 1.0, "routes": routes}


def _serve_prompt(arch, rows):
    """One document a row (the VLM's opening with its vision span; the
    encoder-decoder's one clip of FRAMES frames), seeded."""
    cfg = t_reduced(t_get_arch(arch))
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, cfg.vocab_size, size=(rows, PROMPT)).astype(np.int32)
    ones = np.ones((rows, PROMPT), np.int32)
    pos = np.arange(PROMPT, dtype=np.int32)
    if cfg.enc_dec:
        return {"frame_embeds": rng.standard_normal((rows, FRAMES, cfg.d_model),
                                                    dtype=np.float32),
                "enc_segment_ids": np.ones((rows, FRAMES), np.int32),
                "enc_positions": np.tile(np.arange(FRAMES, dtype=np.int32), (rows, 1)),
                "dec_tokens": tokens, "dec_segment_ids": ones,
                "dec_positions": np.tile(pos, (rows, 1))}
    return {"tokens": tokens, "segment_ids": ones,
            "positions": np.repeat(mrope_positions(pos, VIS, GRID)[None], rows, 0),
            "vision_embeds": rng.standard_normal((rows, VIS, cfg.d_model), dtype=np.float32)}


def _serve_case(name):
    arch, policy, rows = SERVE[name]
    return {"kind": "serve", "arch": arch, "over": {}, "policy": policy, "seed": 3,
            "prompt": _serve_prompt(arch, rows), "steps": SERVE_STEPS, "max_len": MAX_LEN}


def _cases(shape):
    cases = {}
    if shape in TRAIN_SHAPES:
        for arch in FAMILIES:
            _, params, batches = _family(arch)
            cases[f"train-{arch}"] = _step_case(arch, params, batches)
    for name in SERVE_SHAPES.get(shape, ()):
        cases[f"serve-{name}"] = _serve_case(name)
    return cases


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """Every spawned group, started at once when the module's first test
    runs (they run beside the references); `get(shape)` joins one."""
    groups = {shape: dh.launch(dh.mesh_cases, shape[0] * shape[1], shape, _cases(shape))
              for shape in TRAIN_SHAPES}
    _, params, batches = _moe_inputs()
    pod = {f"moe-{v}": _step_case(MOE, params, batches, MOE_OVER, kw, routes=True)
           for v, kw in MOE_VARIANTS.items()}
    groups[POD_SHAPE] = dh.launch(dh.mesh_cases, int(np.prod(POD_SHAPE)), POD_SHAPE, pod,
                                  POD_AXES)

    def get(shape):
        return groups[shape].results(600)
    yield get
    for g in groups.values():
        try:
            g.results(timeout=30)
        except RuntimeError:
            pass


# -------------------------------------------------------------- references
def _port_steps(tcfg, params, batches, *, remat=True):
    """STEPS unsharded fp32 AdamW steps of the port -> losses, each step's
    clipped gradients, the final parameters (numpy, tree_leaves order)."""
    opt = make_optimizer("adamw", lr=LR)
    tp = params_from_jax(params, dtype=torch.float32, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    state = {"params": tp, "opt": opt.init(tp, period=len(tcfg.period)),
             "step": torch.zeros((), dtype=torch.int32)}
    step = build_train_step(tcfg, opt, microbatches=MICROBATCHES, compute_dtype=torch.float32,
                            remat=remat)
    out = {"loss": [], "grads": []}
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        out["loss"].append(float(m["loss"]))
        out["grads"].append([p.grad.detach().numpy().copy()
                             for p in tree_leaves(state["params"])])
    out["params"] = [p.detach().numpy().copy() for p in tree_leaves(state["params"])]
    return out


@functools.lru_cache(maxsize=None)
def _family_reference(arch):
    """The port's unsharded run and the JAX `loss_fn` on step 0 (the mean
    loss and the norm of the mean gradient over the micro-batches)."""
    cfg, params, batches = _family(arch)
    port = _port_steps(t_reduced(t_get_arch(arch)), params, batches)
    jp = jax.tree.map(jnp.asarray, params)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(cfg, p, b, J_NULL, compute_dtype=jnp.float32)[0]))
    n = B // MICROBATCHES
    parts = [grad(jp, {k: jnp.asarray(v[i * n:(i + 1) * n]) for k, v in batches[0].items()})
             for i in range(MICROBATCHES)]
    loss = sum(float(l) for l, _ in parts) / MICROBATCHES
    mean = jax.tree.map(lambda *g: sum(g) / MICROBATCHES, *(g for _, g in parts))
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(mean))))
    return {"port": port, "jax": {"loss": loss, "grad_norm": norm}}


def _assert_params_close(tcfg, params, got, want):
    """The final parameters `got["params"]`: to 1e-5 of each leaf's max of
    the unsharded optimizer replayed on the sharded run's gradients (the
    update is the optimizer's), and to the unsharded run's (`want`) at 1e-5
    of the leaf's max plus 1e-3 lr but for at most 1% of the elements, all
    within 2 lr a step: AdamW's m / (sqrt(v) + eps) moves a parameter whose
    gradient is small with the gradients' rounding (test_torch_sharding)."""
    opt = make_optimizer("adamw", lr=LR)
    p = params_from_jax(params, dtype=torch.float32, device="cpu")
    state = opt.init(p, period=len(tcfg.period))
    for i, grads in enumerate(got["grads"]):
        it = iter(grads)
        g = tree_map(lambda x: torch.from_numpy(next(it)), p)
        opt.update(g, state, p, torch.tensor(i, dtype=torch.int32))
    for i, (a, b) in enumerate(zip(got["params"], tree_leaves(p), strict=True)):
        assert np.abs(a - b.numpy()).max() <= 1e-5 * np.abs(b.numpy()).max() + 1e-12, i
    out = total = 0
    for a, b in zip(got["params"], want, strict=True):
        d = np.abs(a - b)
        assert (d <= 2 * LR * len(got["grads"])).all()
        out += int((d > 1e-5 * np.abs(b).max() + 1e-3 * LR).sum())
        total += b.size
    assert out <= 1e-2 * total


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("shape,arch", TRAIN_CASES,
                         ids=[f"{s[0]}x{s[1]}-{a}" for s, a in TRAIN_CASES])
def test_sharded_family_step_matches_unsharded_and_jax(shape, arch, spawned):
    """2 fp32 steps on the mesh: losses to 1e-5 of the port's unsharded
    step, step-0 gradients to 1e-5 of each leaf's max, the final parameters
    as `_assert_params_close` holds them; step 0's loss and grad norm to
    1e-4 of the JAX `loss_fn` (test_torch_train's tolerance)."""
    got = spawned(shape)[0][f"train-{arch}"]
    ref = _family_reference(arch)
    np.testing.assert_allclose(got["loss"], ref["port"]["loss"], rtol=1e-5)
    assert got["step"] == STEPS
    for i, (a, b) in enumerate(zip(got["grads"][0], ref["port"]["grads"][0], strict=True)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max() + 1e-12, i
    _assert_params_close(t_reduced(t_get_arch(arch)), _family(arch)[1], got,
                         ref["port"]["params"])
    np.testing.assert_allclose(got["loss"][0], ref["jax"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"][0], ref["jax"]["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("shape", [s for s in TRAIN_SHAPES if s[1] == 2],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_vision_rows_are_not_summed_over_tp(shape, spawned):
    """At tp 2 the VLM's sharded loss is the unsharded one to 1e-5, and the
    check has the power to see vision rows summed over tp: the unsharded
    step with its vision embeddings doubled moves the loss far past it."""
    got = spawned(shape)[0]["train-qwen2-vl-7b"]
    ref = _family_reference("qwen2-vl-7b")["port"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    _, params, batches = _family("qwen2-vl-7b")
    doubled = [{**b, "vision_embeds": 2 * b["vision_embeds"]} for b in batches[:1]]
    moved = _port_steps(t_reduced(t_get_arch("qwen2-vl-7b")), params, doubled)["loss"][0]
    assert abs(moved - ref["loss"][0]) > 100 * 1e-5 * abs(ref["loss"][0])


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("shape,name", SERVE_CASES,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in SERVE_CASES])
def test_sharded_family_serving_matches_unsharded(shape, name, spawned):
    got = spawned(shape)[0][f"serve-{name}"]
    plain, sharded = got["plain"], got["sharded"]
    for a, b in [(sharded["prefill"], plain["prefill"])] + list(zip(sharded["logits"],
                                                                    plain["logits"])):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert len(sharded["tokens"]) == SERVE_STEPS
    for a, b in zip(sharded["tokens"], plain["tokens"]):
        np.testing.assert_array_equal(a, b)
    want = PLACED[name.split("-")[-1]][shape]
    assert sharded["cache_placements"] == want and plain["cache_placements"] == "None"
    if SERVE[name][0] == "whisper-medium":  # the cross cache, placed as the self cache
        assert sharded["cross_placements"] == want


# ------------------------------------------------------------ MoE over pods
@contextlib.contextmanager
def _moe_per_shard(shards):
    """The port's MoE layer as the reference's shard_map runs it over the
    (pod, data) shards: `_moe_math` on each shard's rows alone (its own
    capacity and ranks), the shards' outputs concatenated."""
    def per_shard(cfg, p, x, policy=NULL_POLICY):
        return torch.cat([moe.moe_ffn(cfg, p, c) for c in x.chunk(shards)], 0)
    saved = t_model.FFN_FN["moe"]
    t_model.FFN_FN["moe"] = per_shard
    try:
        yield
    finally:
        t_model.FFN_FN["moe"] = saved


@functools.lru_cache(maxsize=None)
def _moe_reference():
    """The unsharded steps with each shard capped alone, without remat (as
    the spawned cases run), and the routes of every call of step 0: one
    entry a call and shard, calls in order, shards pod-major."""
    _, params, batches = _moe_inputs()
    tcfg = t_reduced(t_get_arch(MOE), **MOE_OVER)
    moe.moe_ffn.routes = []
    gaps, route = [], moe.route

    def checked(cfg_, router, xt):
        probs = torch.softmax(xt.detach().float() @ router.detach().float(), dim=-1)
        top = torch.sort(probs.double(), dim=-1, descending=True).values
        gaps.append(float((top[..., cfg_.moe_top_k - 1] - top[..., cfg_.moe_top_k]).min()))
        return route(cfg_, router, xt)
    moe.route = checked
    try:
        with _moe_per_shard(POD_SHARDS):
            out = _port_steps(tcfg, params, batches, remat=False)
        routes = moe.moe_ffn.routes[:len(moe.moe_ffn.routes) // len(batches)]  # step 0's
    finally:
        moe.moe_ffn.routes = None
        moe.route = route
    return out, [{k: r[k].numpy() for k in ("experts", "kept")} for r in routes], min(gaps)


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_over_pod_and_data_matches_unsharded(variant, spawned):
    """The EP and TP variants on the (2, 2, 1) pod mesh: losses to 1e-5 of
    the unsharded step capped per (pod, data) shard, step-0 gradients to
    1e-5 of each leaf's max, the final parameters as `_assert_params_close`
    holds them; every rank's routes and drops of step 0 those of its
    shard, pod-major (and the capacity drops tokens)."""
    results = spawned(POD_SHAPE)
    ref, routes, gap = _moe_reference()
    assert gap > 1e-5  # no router near-tie: every run picks the same experts
    got = results[0][f"moe-{variant}"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for i, (a, b) in enumerate(zip(got["grads"][0], ref["grads"][0], strict=True)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max() + 1e-12, i
    _assert_params_close(t_reduced(t_get_arch(MOE), **MOE_OVER), _moe_inputs()[1], got,
                         ref["params"])
    assert not all(r["kept"].all() for r in routes)
    calls = len(routes) // POD_SHARDS
    assert calls == MICROBATCHES * t_reduced(t_get_arch(MOE)).n_layers
    for r in results.values():
        mine = r[f"moe-{variant}"]
        pod, data, _ = mine["coords"]
        shard = pod * POD_SHAPE[1] + data
        assert len(mine["routes"]) == calls
        for c, local in enumerate(mine["routes"]):
            for k in ("experts", "kept"):
                np.testing.assert_array_equal(local[k], routes[c * POD_SHARDS + shard][k])
