"""The port's sharding (`repro_torch.parallel.sharding`, the sharded train
state and step, the MoE layer's TP/EP path, `--tp` in the spmd driver)
against the JAX package and against the port's own unsharded step, on the
CPU:

  * rules: the port's `spec_for` equals the JAX `spec_for` on every leaf of
    every arch's train state at full size (shapes only: JAX by
    `state_axes` / `sharding_for_state`, the port by `init_params` on the
    meta device), AdamW and Adafactor, over `FakeMesh` shapes (1,1) to
    (1,8), and for each policy variant; `policy_for_mesh`, `batch_spec`,
    and specs of activations;
  * placements: `placements_for` turns a spec into DTensor placements whose
    local shards are the spec's (JAX's) blocks, two mesh axes on one dim
    major first;
  * spawned gloo ranks (`torch_dist_helpers`) on meshes (2,1), (1,2) and
    (2,2): 3 fp32 steps (2 micro-batches, AdamW; one Adafactor case) of
    reduced qwen3-8b, gemma3-1b cut to a sliding-window and a global layer
    (tp 2: 4 heads split, its one kv head whole; tied embeddings; once
    more with `seq_parallel`), qwen3-moe with EP and with per-expert TP,
    each against the port's unsharded step (losses to 1e-5, the step-0
    gradients to 1e-5 of each leaf's max, the parameters to 1e-5 of the
    leaf's max plus 1e-3 * lr but for at most 1% of them) and to its
    optimizer replayed on the sharded gradients (parameters to 1e-5 of the
    leaf's max), and against the JAX step (losses and grad norms to 1e-4,
    test_torch_train's tolerance); where dp splits an MoE model's tokens,
    both unsharded steps cap the MoE layer per data shard, as the
    reference's shard_map does; the MoE layer against the JAX `_moe_math`
    and the single-device `moe_ffn` on each data shard; a (1,1) mesh
    against the unsharded step and serving;
  * bf16 gradient accumulation (`accum_dtype`) on (1,2): one step of
    reduced qwen3-8b against the port's unsharded bf16 step and the JAX
    bf16 step;
  * the driver: `torchrun --nproc-per-node 2 ... --tp 2` trains sharded
    on the CPU; a checkpoint saved on (2,2) resumes on (2,1) and the
    losses go on;
  * every family's step builders take a mesh: the dense ones, the VLM and
    encoder-decoder ones (tests/test_torch_sharding_families.py) and the
    recurrent ones (tests/test_torch_sharding_recurrent.py).

Every spawned group starts when the first test that needs one asks, all at
once, and each rank's collectives time out (`torch_dist_helpers`).

AdamW's update m / (sqrt(v) + eps) follows the rounding of a small
gradient, so two runs whose gradients agree to 1e-5 of their leaf's max
still part on a few parameters; `test_sharded_step_matches_unsharded`
says how each quantity is held.
"""
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_arch, reduced
from repro.data.synth import SyntheticPackedDataset
from repro.models import model as j_model, moe as j_moe
from repro.models.model import loss_fn as j_loss_fn, stacked_init
from repro.parallel import sharding as j_sharding
from repro.parallel.sharding import NULL_POLICY as J_NULL, split_annotations
from repro.train import train_step as j_train_step
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.models import model as t_model, moe
from repro_torch.models.model import init_params, param_axes
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import NULL_POLICY, ShardingPolicy, policy_for_mesh
from repro_torch.train.optimizer import make_optimizer, tree_leaves, tree_map
from repro_torch.train.train_step import (
    build_prefill_step,
    build_serve_step,
    build_train_step,
    sharding_for_state,
    state_axes,
)

import torch_dist_helpers as dh

ROOT = Path(__file__).resolve().parents[1]
J_STATE_AXES = j_train_step.state_axes  # the tests patch the module's name
LR = 1e-3
S, B, STEPS = 64, 4, 3


class FakeMesh:
    """The reference's test mesh: sizes only."""

    def __init__(self, data, model, names=("data", "model")):
        self.shape = dict(zip(names, (data, model)))
        self.axis_names = names


MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (2, 4), (4, 2), (8, 1), (1, 8)]
VARIANTS = {"default": {}, "attn-head_dim": {"attn_shard": "head_dim"},
            "attn-none": {"attn_shard": None}, "expert_parallel": {"expert_parallel": True},
            "seq_parallel": {"seq_parallel": True}, "no-fsdp": {"fsdp": False},
            "no-shard_batch": {"shard_batch": False},
            "no-kv-seq": {"decode_kv_seq_shard": False}}
ACTIVATIONS = [(("batch", "seq", None), (8, 4096, 4096)),
               (("batch", "seq", "heads", "head_dim"), (8, 4096, 32, 128)),
               (("batch", "seq", "heads", "head_dim"), (8, 4096, 4, 256)),
               (("batch", "seq", "vocab"), (8, 4096, 151936)),
               (("batch", "seq", "ffn"), (8, 4096, 12288)),
               (("batch", "seq", "dinner"), (8, 4096, 16384)),
               (("batch", "kv_seq", "kv_heads", "head_dim"), (1, 524288, 8, 128)),
               (("batch", "kv_seq", "kv_heads", "head_dim"), (8, 32768, 1, 256)),
               (("batch", None, None), (8, 1, 4096))]


# ------------------------------------------------------------------- rules
@pytest.fixture(scope="module")
def jax_state_axes():
    """JAX `state_axes` by (arch, optimizer), once each (it traces the init)."""
    cache = {}

    def get(arch, opt):
        if (arch, opt) not in cache:
            cache[arch, opt] = J_STATE_AXES(get_arch(arch), j_make_optimizer(opt))
        return cache[arch, opt]
    return get


@pytest.fixture(scope="module")
def port_state_axes():
    cache = {}

    def get(arch, opt):
        if (arch, opt) not in cache:
            cache[arch, opt] = state_axes(t_get_arch(arch), make_optimizer(opt))
        return cache[arch, opt]
    return get


def _policies(shape, kw):
    return (j_sharding.ShardingPolicy(mesh=FakeMesh(*shape), dp_axes=("data",),
                                      tp_axis="model", **kw),
            ShardingPolicy(mesh=FakeMesh(*shape), dp_axes=("data",), tp_axis="model", **kw))


def _jax_specs(monkeypatch, jax_state_axes, arch, opt, jpol):
    """The JAX `sharding_for_state`'s spec tree (its sharding_for read as
    spec_for, its state_axes cached)."""
    monkeypatch.setattr(j_sharding.ShardingPolicy, "sharding_for",
                        lambda self, axes, shape: tuple(self.spec_for(axes, shape)))
    monkeypatch.setattr(j_train_step, "state_axes", lambda cfg, o: jax_state_axes(arch, opt))
    return j_train_step.sharding_for_state(jpol, get_arch(arch), j_make_optimizer(opt))[0]


def _pairs(cfg, port, ref):
    """(port spec, JAX spec) per leaf of the state: the port's list of layers
    against the reference's stacks (layer j*P + pos is row j of stack pos:
    its spec has the stack's "layers" entry, which is never sharded, first);
    Adafactor's statistics are stacked in both."""
    out = []

    def walk(p, r, key=None):
        if isinstance(p, dict):
            assert set(p) == set(r), (key, set(p), set(r))
            for k in p:
                walk(p[k], r[k], k)
        elif isinstance(p, list):  # the list of layers against the stacks
            P = len(cfg.period) if key == "layers" else 1
            assert isinstance(r, tuple) and len(r) == P
            for i, layer in enumerate(p):
                walk_layer(layer, r[i % P])
        elif isinstance(p, tuple) and p and not sharding.is_axes(p):
            assert len(p) == len(r)
            for a, b in zip(p, r):
                walk(a, b)
        else:
            out.append((p, tuple(r)))

    def walk_layer(p, r):
        if isinstance(p, dict):
            for k in p:
                walk_layer(p[k], r[k])
        else:
            assert tuple(r)[0] is None
            out.append((p, tuple(r)[1:]))
    walk(port, ref)
    return out


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_state_specs_match_jax(arch, opt, monkeypatch, jax_state_axes, port_state_axes):
    """Every leaf of the full-size train state (params, optimizer state, step)
    on every mesh shape, default policy."""
    shapes, axes = port_state_axes(arch, opt)
    for shape in MESHES:
        jpol, pol = _policies(shape, {})
        want = _jax_specs(monkeypatch, jax_state_axes, arch, opt, jpol)
        got = pol.tree_specs(axes, shapes)
        pairs = _pairs(t_get_arch(arch), got, want)
        assert len(pairs) == len(tree_leaves(shapes)) > 10
        assert all(a == b for a, b in pairs), [(a, b) for a, b in pairs if a != b][:5]
        if shape == (2, 4):  # the rules shard something on both axes
            flat = {e for a, _ in pairs for e in a}
            assert {"data", "model"} <= flat


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_policy_variants_match_jax(variant, monkeypatch, jax_state_axes, port_state_axes):
    """Each policy variant on (2,4) and (4,2): every arch's parameters and
    Adafactor state, and the activations' specs."""
    for shape in [(2, 4), (4, 2)]:
        jpol, pol = _policies(shape, VARIANTS[variant])
        for axes, dims in ACTIVATIONS:
            assert pol.spec_for(axes, dims) == tuple(jpol.spec_for(axes, dims)), (axes, dims)
        assert pol.batch_spec() == tuple(jpol.batch_spec())
        for arch in ASSIGNED_ARCHS:
            shapes, axes = port_state_axes(arch, "adafactor")
            want = _jax_specs(monkeypatch, jax_state_axes, arch, "adafactor", jpol)
            got = pol.tree_specs(axes, shapes)
            assert all(a == b for a, b in _pairs(t_get_arch(arch), got, want)), arch


def test_kv_seq_takes_every_axis_without_batch_sharding():
    jpol, pol = _policies((2, 4), {"shard_batch": False})
    axes, dims = ("batch", "kv_seq", "kv_heads", "head_dim"), (1, 524288, 8, 128)
    assert pol.spec_for(axes, dims) == tuple(jpol.spec_for(axes, dims)) == \
        (None, ("data", "model"), None, None)
    assert pol.placements_for(axes, dims) == [torch.distributed.tensor.Shard(1)] * 2


def test_policy_for_mesh_sizes_and_null_policy():
    for names in [("data", "model"), ("pod", "data", "model"), ("replica", "model"),
                  ("data",), ("model",), ("x", "y")]:
        mesh = FakeMesh(1, 1)
        mesh.shape, mesh.axis_names = {a: 2 for a in names}, names
        a, b = policy_for_mesh(mesh), j_sharding.policy_for_mesh(mesh)
        assert (a.dp_axes, a.tp_axis, a.tp, a.dp) == (b.dp_axes, b.tp_axis, b.tp, b.dp)
        assert a.batch_spec() == tuple(b.batch_spec())
        kw = policy_for_mesh(mesh, expert_parallel=True, attn_shard=None)
        assert kw.expert_parallel and kw.attn_shard is None
    assert policy_for_mesh(None) is NULL_POLICY and j_sharding.policy_for_mesh(None) is J_NULL
    x = torch.zeros(4, 8)
    assert NULL_POLICY.constrain(x, "batch", "seq") is x and NULL_POLICY.distribute(x, ()) is x
    assert NULL_POLICY.tp == NULL_POLICY.dp == 1 and NULL_POLICY.batch_spec() == ()
    assert NULL_POLICY.replace(fsdp=False).fsdp is False


def test_param_axes_mirror_init_params(jax_state_axes):
    """`param_axes` has `init_params`' tree, one axis name (or None) per dim;
    the meta init allocates nothing, has the real init's shapes, and as many
    parameters as the JAX tree."""
    for arch in ASSIGNED_ARCHS:
        cfg = t_get_arch(arch)
        axes, meta = param_axes(cfg), init_params(cfg, device="meta")
        pairs = []
        sharding.tree_map_axes(lambda ax, t: pairs.append((ax, t)), axes, meta)
        assert len(pairs) == len(tree_leaves(meta))
        assert all(len(ax) == t.dim() and t.is_meta for ax, t in pairs), arch
        small = t_reduced(cfg)
        real = init_params(small, device="cpu")
        assert [t.shape for t in tree_leaves(real)] == \
            [t.shape for t in tree_leaves(init_params(small, device="meta"))]
        assert sum(t.numel() for t in tree_leaves(meta)) == \
            sum(x.size for x in jax.tree.leaves(jax_state_axes(arch, "adamw")[0]))


def test_sharding_for_state_places_every_leaf():
    pol = ShardingPolicy(mesh=FakeMesh(2, 2), dp_axes=("data",), tp_axis="model")
    placements, shapes, axes = sharding_for_state(pol, t_get_arch("qwen3-8b"),
                                                  make_optimizer("adamw"))
    emb = placements["params"]["embed"]  # (vocab, dmodel): (model, data)
    S_, R = torch.distributed.tensor.Shard, torch.distributed.tensor.Replicate
    assert emb == [S_(1), S_(0)] and placements["step"] == [R(), R()]
    assert placements["opt"]["m"]["layers"][0]["mixer"]["wq"] == [S_(0), S_(1)]
    none, _, _ = sharding_for_state(NULL_POLICY, t_get_arch("qwen3-8b"), make_optimizer("adamw"))
    assert all(x is None for x in tree_leaves(none["params"]))
    assert shapes["params"]["embed"].is_meta and axes["step"] == ()


def test_placements_from_specs():
    """Two mesh axes on one dim in mesh order, a size-1 axis replicated (the
    same layout), axes against mesh order refused."""
    pol = ShardingPolicy(mesh=FakeMesh(2, 2), dp_axes=("data",), tp_axis="model")
    with pytest.raises(NotImplementedError, match="mesh order"):
        pol.placements_from_spec((("model", "data"),))
    S_, R = torch.distributed.tensor.Shard, torch.distributed.tensor.Replicate
    assert pol.placements_from_spec((("data", "model"), None)) == [S_(0), S_(0)]
    one = pol.replace(mesh=FakeMesh(1, 2))
    assert one.spec_for(("vocab", "dmodel"), (512, 64)) == ("model", "data")
    assert one.placements_for(("vocab", "dmodel"), (512, 64)) == [R(), S_(0)]


def test_refusals_name_the_roadmap():
    """Under a mesh no family refuses any more: the dense, VLM, enc-dec and
    recurrent families (xlstm, jamba, once refused with a NotImplementedError
    naming ROADMAP Queue 1) build the train step, serving and prefill
    (across ranks: tests/test_torch_serve_mesh.py,
    tests/test_torch_sharding_families.py and
    tests/test_torch_sharding_recurrent.py)."""
    pol = ShardingPolicy(mesh=FakeMesh(2, 2), dp_axes=("data",), tp_axis="model")
    opt = make_optimizer("adamw")
    for arch in ["qwen3-8b", "qwen2-vl-7b", "whisper-medium", "xlstm-1.3b",
                 "jamba-1.5-large-398b"]:
        cfg = t_reduced(t_get_arch(arch))
        build_train_step(cfg, opt, policy=pol)
        build_serve_step(cfg, policy=pol)
        build_prefill_step(cfg, policy=pol)


@pytest.mark.parametrize("H,K,tp", [(4, 1, 2), (32, 4, 8), (32, 8, 2), (6, 3, 2), (6, 2, 3),
                                    (8, 2, 8)])
def test_kv_heads_for_local_q_heads(H, K, tp):
    """Where the q heads are split over tp and the kv heads are not, each
    rank's kv heads, read by the kernel's own map over its local heads
    (h * K' // H'), are the ones its global q heads read (h * K // H): a
    contiguous slice where that map allows, else one kv head a q head."""
    from repro_torch.models.attention import _kv_for_local_heads

    k = torch.arange(K, dtype=torch.float32).view(1, 1, K, 1)
    Hl = H // tp
    for r in range(tp):
        kl, vl = _kv_for_local_heads(k, k + 100, H, r * Hl, Hl)
        K_l = kl.shape[2]
        got = [int(kl[0, 0, h * K_l // Hl, 0]) for h in range(Hl)]
        assert got == [(r * Hl + h) * K // H for h in range(Hl)]
        assert torch.equal(vl, kl + 100)
        assert K_l <= Hl


# ------------------------------------------------------- spawned meshes
def _filled(batch):
    """Each row's padding made one more document whose labels stay -1 (the
    reference's jnp attention gives a padding row the mean of V; with MoE a
    padding row takes expert capacity), as test_torch_moe fills it."""
    batch = {k: v.copy() for k, v in batch.items()}
    seg, pos = batch["segment_ids"], batch["positions"]
    for b in range(seg.shape[0]):
        pad = seg[b] == 0
        seg[b, pad] = seg[b].max() + 1
        pos[b, pad] = np.arange(int(pad.sum()))
    return batch


# gemma3-1b runs cut to 2 layers, a sliding-window one and a global one: "gemma2"
# name: (arch, its cut (None: `reduced`'s), policy keywords, (optimizer, momentum))
MODELS = {
    "qwen3-8b": ("qwen3-8b", None, {}, ("adamw", "float32")),
    "gemma3-1b": ("gemma3-1b", "gemma2", {}, ("adamw", "float32")),
    "gemma3-1b-sp": ("gemma3-1b", "gemma2", {"seq_parallel": True}, ("adamw", "float32")),
    "qwen3-moe-ep": ("qwen3-moe-30b-a3b", None, {"expert_parallel": True}, ("adamw", "float32")),
    "qwen3-moe-tp": ("qwen3-moe-30b-a3b", None, {}, ("adamw", "float32")),
    "qwen3-moe-adafactor": ("qwen3-moe-30b-a3b", None, {"expert_parallel": True},
                            ("adafactor", "float32")),
}
SHAPES = [(2, 1), (1, 2), (2, 2)]
# gemma3-1b where tp splits its 4 heads and not its kv head (also with the
# sequence split over tp between blocks); Adafactor on (2,2)
SHAPE_MODELS = {(2, 1): ["qwen3-8b", "qwen3-moe-ep", "qwen3-moe-tp"],
                (1, 2): ["qwen3-8b", "gemma3-1b", "gemma3-1b-sp", "qwen3-moe-ep", "qwen3-moe-tp"],
                (2, 2): [m for m in MODELS if m != "gemma3-1b-sp"]}
CASES = [(s, m) for s in SHAPES for m in SHAPE_MODELS[s]]
JAX_CASES = [(s, m) for s, m in CASES if MODELS[m][3][0] == "adamw"]


def _over(spec):
    if spec == "gemma2":  # one sliding-window layer, one global
        period = get_arch("gemma3-1b").period
        return {"n_layers": 2, "period": (period[0], period[5])}
    return spec or {}


@functools.lru_cache(maxsize=None)
def _weights_and_batches(arch, over_spec):
    """The JAX config, `stacked_init` weights (numpy) and filled batches of
    a model (shared by the cases of one arch)."""
    cfg = reduced(get_arch(arch), **_over(over_spec))
    jparams, _ = split_annotations(stacked_init(jax.random.PRNGKey(5), cfg))
    batches = [_filled(SyntheticPackedDataset(cfg, S, B, seed=11, mu=3.6, sigma=0.8)
                       .batch_at(i)) for i in range(STEPS)]
    return cfg, jax.tree.map(np.asarray, jparams), batches


def _model_inputs(name):
    arch, over, kw, opt = MODELS[name]
    cfg, params, batches = _weights_and_batches(arch, over)
    return cfg, _over(over), kw, opt, params, batches


def _step_case(name):
    _, over, kw, opt, params, batches = _model_inputs(name)
    return {"kind": "step", "arch": MODELS[name][0], "over": over, "policy": kw, "opt": opt,
            "params": params, "batches": batches, "lr": LR, "microbatches": 2,
            "clip_norm": 1.0}


def _bf16_accum_case():
    """One step of reduced qwen3-8b, its gradients accumulated in bf16."""
    case = _step_case("qwen3-8b")
    return {**case, "batches": case["batches"][:1], "accum_dtype": "bfloat16"}


MOE_LAYER_OVER = {"capacity_factor": 0.5}  # 16 slots an expert for 64 x 2 assignments


@functools.lru_cache(maxsize=None)
def _moe_layer_inputs(seed):
    cfg = reduced(get_arch("qwen3-moe-30b-a3b"), **MOE_LAYER_OVER)
    rng = np.random.default_rng(seed)
    p, _ = split_annotations(stacked_init(jax.random.PRNGKey(seed), cfg))
    layer = {k: np.asarray(v[0]) for k, v in p["layers"][0]["ffn"].items()}
    x = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    return layer, x, dy


PLACEMENT_SPECS = [(("vocab", "dmodel"), (512, 64), {}),
                   (("batch", "seq", "heads", "head_dim"), (4, 8, 4, 16), {}),
                   (("dmodel", "kv_heads", "head_dim"), (64, 1, 16), {}),
                   (("expert", "dmodel", "ffn"), (4, 64, 64), {"expert_parallel": True}),
                   (("batch", "kv_seq", "kv_heads", "head_dim"), (1, 64, 2, 16),
                    {"shard_batch": False}),
                   (("layers", "dmodel"), (3, 64), {})]


def _mesh_cases(shape, ckpt_dir):
    cases = {name: _step_case(name) for name in SHAPE_MODELS[shape]}
    layer, x, dy = _moe_layer_inputs(3)
    for mode, kw in (("ep", {"expert_parallel": True}), ("tp", {})):
        cases["moe-layer-" + mode] = {"kind": "moe_layer", "arch": "qwen3-moe-30b-a3b",
                                      "over": MOE_LAYER_OVER, "policy": kw, "p": layer,
                                      "x": x, "dy": dy}
    if shape == (1, 2):  # the reference's accumulation above 5e10 parameters
        cases["qwen3-8b-bf16-accum"] = _bf16_accum_case()
    if shape == (2, 2):
        cases["placements"] = {"kind": "placements", "specs": PLACEMENT_SPECS}
        cases["driver-save"] = {"kind": "driver", "argv": _driver_argv(
            ["--tp", "2", "--ckpt-dir", str(ckpt_dir), "--ckpt-interval", "2"])}
    return cases


def _driver_argv(extra):
    return ["--reduced", "--steps", "3", "--seq-len", "64", "--batch", "4", "--device", "cpu",
            *extra]


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """Every spawned group, started at once when the module's first test
    runs (they run beside the rules tests); `get(name)` joins one."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    out = tmp_path_factory.mktemp("torchrun") / "out.json"
    groups = {shape: dh.launch(dh.mesh_cases, shape[0] * shape[1], shape,
                               _mesh_cases(shape, ckpt)) for shape in SHAPES}
    one = _model_inputs("qwen3-8b")
    prompt = {k: v[:2, :24] for k, v in one[5][0].items() if k in ("tokens", "segment_ids",
                                                                     "positions")}
    groups[(1, 1)] = dh.launch(dh.mesh_cases, 1, (1, 1), {"one": {
        "kind": "one_rank", "arch": "qwen3-8b", "over": {}, "params": one[4],
        "batches": one[5], "lr": LR, "prompt": prompt}})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    log = open(out.with_suffix(".log"), "w")
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", str(dh.free_port()), "-m", "repro_torch.launch.train",
         *_driver_argv(["--tp", "2", "--out", str(out)])],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    state = {"resume": None}

    def get(name):
        if name == "torchrun":
            try:
                torchrun.wait(timeout=300)
            except subprocess.TimeoutExpired:
                torchrun.kill()
                raise
            assert torchrun.returncode == 0, out.with_suffix(".log").read_text()[-4000:]
            import json
            return json.loads(out.read_text())
        if name == "resume":  # after the (2,2) group saved its checkpoint
            if state["resume"] is None:
                groups[(2, 2)].results()
                state["resume"] = dh.launch(dh.mesh_cases, 2, (2, 1), {"driver-resume": {
                    "kind": "driver", "argv": _driver_argv(
                        ["--tp", "1", "--ckpt-dir", str(ckpt), "--resume"])}})
            return state["resume"].results()
        return groups[name].results()
    yield get
    for g in [*groups.values(), state["resume"]]:
        if g is not None:
            try:
                g.results(timeout=30)
            except RuntimeError:
                pass
    if torchrun.poll() is None:
        torchrun.kill()
    log.close()


def _moe_dp(name, shape):
    """The data shards an MoE layer caps alone on `shape` (1: none, or no MoE)."""
    return shape[0] if MODELS[name][0] == "qwen3-moe-30b-a3b" else 1


@contextlib.contextmanager
def _moe_per_shard(dp):
    """Both packages' MoE layers run as the reference's shard_map runs them
    over dp data shards: `_moe_math` on each shard's rows alone (its own
    capacity and ranks), the shards' outputs concatenated."""
    def port(cfg, p, x, policy=NULL_POLICY):
        return torch.cat([moe.moe_ffn(cfg, p, c) for c in x.chunk(dp)], 0)

    def ref(cfg, p, x, policy):
        return jnp.concatenate([j_moe._moe_math(cfg, p["router"], p["w_gate"], p["w_up"],
                                                p["w_down"], c) for c in jnp.split(x, dp)], 0)
    saved = t_model.FFN_FN["moe"], j_model.moe_ffn
    if dp > 1:
        t_model.FFN_FN["moe"], j_model.moe_ffn = port, ref
    try:
        yield
    finally:
        t_model.FFN_FN["moe"], j_model.moe_ffn = saved


@pytest.fixture(scope="module")
def references():
    """By model and mesh shape: the port's unsharded run (losses, grads of
    every step, final parameters and optimizer state) and the JAX step's
    (losses, grad norms, final parameters), from the same inputs; where
    the mesh splits an MoE model's tokens over dp, both with the MoE layer
    capped per data shard, as the reference's shard_map caps it."""
    cache = {}

    def get(name, shape):
        dp = _moe_dp(name, shape)
        key = (MODELS[name][0], MODELS[name][1], MODELS[name][3], dp)  # EP and TP share one
        if key not in cache:
            with _moe_per_shard(dp):
                cache[key] = run(name)
        return cache[key]

    def run(name):
        cfg, over, kw, opt, params, batches = _model_inputs(name)
        tcfg = t_reduced(t_get_arch(MODELS[name][0]), **over)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
        topt = make_optimizer(opt[0], lr=LR, momentum_dtype=getattr(torch, opt[1]))
        tp = params_from_jax(params, dtype=torch.float32, device="cpu")
        for p in tree_leaves(tp):
            p.requires_grad_(True)
        state = {"params": tp, "opt": topt.init(tp, period=len(tcfg.period)),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = build_train_step(tcfg, topt, microbatches=2, compute_dtype=torch.float32)
        gaps, route = [], moe.route

        def checked(cfg_, router, xt):
            probs = torch.softmax(xt.detach().float() @ router.detach().float(), dim=-1)
            top = torch.sort(probs.double(), dim=-1, descending=True).values
            k = cfg_.moe_top_k
            gaps.append(float((top[..., k - 1] - top[..., k]).min()))
            return route(cfg_, router, xt)
        moe.route = checked
        try:
            port = {"loss": [], "grads": []}
            for batch in batches:
                state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
                port["loss"].append(float(m["loss"]))
                port["grads"].append([p.grad.detach().numpy().copy()
                                      for p in tree_leaves(state["params"])])
        finally:
            moe.route = route
        port["params"] = [p.detach().numpy().copy() for p in tree_leaves(state["params"])]
        port["opt"] = [x.float().numpy().copy() for x in tree_leaves(state["opt"])]
        ref = {"port": port, "gap": min(gaps) if gaps else None}
        if MODELS[name][3][0] == "adamw":
            def fp32_loss(cfg_, params_, batch, policy, **k):
                return j_loss_fn(cfg_, params_, batch, policy, compute_dtype=jnp.float32, **k)
            saved = j_train_step.loss_fn
            j_train_step.loss_fn = fp32_loss  # read when the step is traced, at its first call
            try:
                jopt = j_make_optimizer("adamw", lr=LR)
                jstep = jax.jit(j_train_step.build_train_step(cfg, J_NULL, jopt, microbatches=2))
                jp = jax.tree.map(jnp.asarray, params)
                js = {"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
                jl, jg, jn = [], [], []
                for batch in batches:
                    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
                    jl.append(float(jm["loss"]))
                    jg.append(float(jm["grad_norm"]))
                    jn.append(float(jm["ntokens"]))
            finally:
                j_train_step.loss_fn = saved
            ref["jax"] = {"loss": jl, "grad_norm": jg, "ntokens": jn}
        return ref
    return get


def _outliers(got, want):
    """Elements of the parameters beyond 1e-5 of their leaf's max plus 1e-3
    * lr, out of all; asserts every element within 2 * lr * steps, the
    bound any two AdamW runs from one start obey."""
    out = total = 0
    for a, b in zip(got, want):
        d = np.abs(a - b)
        assert (d <= 2 * LR * STEPS).all()
        out += int((d > 1e-5 * np.abs(b).max() + 1e-3 * LR).sum())
        total += b.size
    return out, total


@pytest.mark.parametrize("shape,name", CASES, ids=[f"{s[0]}x{s[1]}-{m}" for s, m in CASES])
def test_sharded_step_matches_unsharded(shape, name, spawned, references):
    """3 fp32 steps on the mesh against the port's unsharded step: losses to
    1e-5 relative; the step-0 clipped gradients to 1e-5 of their leaf's
    max, the later steps' (which follow parameters that AdamW's rounding
    already moved) to 1e-4; the parameters to 1e-5 of the leaf's max of the unsharded
    optimizer replayed on the sharded gradients (the update is the
    optimizer's), and to the unsharded run's parameters at 1e-5 of the
    leaf's max plus 1e-3 * lr but for at most 1% of the elements (AdamW's
    m / (sqrt(v) + eps) moves a parameter whose gradient is small with the
    gradients' rounding), all within 2 * lr * steps; the second-moment
    statistics (Adafactor's factored over sharded axes: a per-shard sum
    would be off by about the shard count) to 2e-4, as they square the
    later steps' gradients."""
    got = spawned(shape)[0][name]
    ref = references(name, shape)
    if ref["gap"] is not None:
        assert ref["gap"] > 1e-5  # no router near-tie: every run picks the same experts
    np.testing.assert_allclose(got["loss"], ref["port"]["loss"], rtol=1e-5)
    assert got["step"] == STEPS
    for step, (gs, ws) in enumerate(zip(got["grads"], ref["port"]["grads"])):
        for i, (a, b) in enumerate(zip(gs, ws)):
            tol = 1e-5 if step == 0 else 1e-4
            assert np.abs(a - b).max() <= tol * np.abs(b).max() + 1e-12, (step, i)
    replay = _replay(name, _model_inputs(name)[4], got["grads"])
    for i, (a, b) in enumerate(zip(got["params"], replay)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max() + 1e-12, i
    out, total = _outliers(got["params"], ref["port"]["params"])
    assert out <= 1e-2 * total
    # the second-moment statistics (after the momenta): global sums, not
    # per-shard ones (Adafactor's vr and vc reduce over sharded axes)
    n_params = len(ref["port"]["params"])
    assert len(got["opt"]) == len(ref["port"]["opt"]) > n_params
    for a, b in zip(got["opt"][n_params:], ref["port"]["opt"][n_params:]):
        assert np.abs(a - b).max() <= 2e-4 * np.abs(b).max() + 1e-30


def _replay(name, params, grads_by_step):
    """The unsharded optimizer's steps from `params` with the given
    gradients (numpy, in tree_leaves order): the final parameters."""
    arch, over, _, (opt_name, momentum) = MODELS[name]
    cfg = t_reduced(t_get_arch(arch), **_over(over))
    opt = make_optimizer(opt_name, lr=LR, momentum_dtype=getattr(torch, momentum))
    p = params_from_jax(params, dtype=torch.float32, device="cpu")
    state = opt.init(p, period=len(cfg.period))
    for i, grads in enumerate(grads_by_step):
        it = iter(grads)
        g = tree_map(lambda x: torch.from_numpy(next(it)), p)
        opt.update(g, state, p, torch.tensor(i, dtype=torch.int32))
    return [x.numpy() for x in tree_leaves(p)]


@pytest.mark.parametrize("shape,name", JAX_CASES,
                         ids=[f"{s[0]}x{s[1]}-{m}" for s, m in JAX_CASES])
def test_sharded_step_matches_jax(shape, name, spawned, references):
    """The same 3 steps against the JAX step (AdamW, 2 micro-batches): loss
    and grad norm to 1e-4 relative at every step (the parameters are held
    to the port's unsharded step and to its optimizer above; that step to
    the JAX one in test_torch_train and test_torch_moe)."""
    got = spawned(shape)[0][name]
    ref = references(name, shape)
    if ref["gap"] is not None:
        assert ref["gap"] > 1e-5  # no router near-tie: JAX picks the port's experts
    np.testing.assert_allclose(got["loss"], ref["jax"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], ref["jax"]["grad_norm"], rtol=1e-4)
    assert got["ntokens"] == ref["jax"]["ntokens"]


@pytest.mark.parametrize("mode", ["ep", "tp"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_layer_matches_single_device(shape, mode, spawned):
    """The TP/EP path against the reference's shard_map on the same layer
    and tokens (4 x 16, capacity binding: tokens dropped), where each of
    the dp data shards is routed, ranked and capped alone: the output to
    1e-5 of max against the JAX `_moe_math` on each shard; output, input
    and weight gradients to 1e-5 of max against the single-device
    `moe_ffn` on each shard; every token's experts and drops. At dp 2 the
    per-shard layer is not the whole batch's (each shard's capacity binds
    on its own tokens)."""
    results = spawned(shape)
    layer, x, dy = _moe_layer_inputs(3)
    dp = shape[0]
    cfg = t_reduced(t_get_arch("qwen3-moe-30b-a3b"), **MOE_LAYER_OVER)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in layer.items()}
    tx = torch.tensor(x, requires_grad=True)
    moe.moe_ffn.routes = []
    try:
        y = torch.cat([moe.moe_ffn(cfg, p, c) for c in tx.chunk(dp)], 0)
        routes = {k: torch.cat([r[k] for r in moe.moe_ffn.routes]) for k in ("experts", "kept")}
    finally:
        moe.moe_ffn.routes = None
    (y * torch.from_numpy(dy)).sum().backward()
    assert not bool(routes["kept"].all())  # the capacity drops tokens
    jcfg = reduced(get_arch("qwen3-moe-30b-a3b"), **MOE_LAYER_OVER)
    jw = [jnp.asarray(layer[k]) for k in ("router", "w_gate", "w_up", "w_down")]
    jy = np.concatenate([np.asarray(j_moe._moe_math(jcfg, *jw, jnp.asarray(c)))
                         for c in np.split(x, dp)])
    assert np.abs(jy - y.detach().numpy()).max() <= 1e-5 * np.abs(jy).max()
    if dp > 1:
        with torch.no_grad():
            whole = moe.moe_ffn(cfg, p, tx)
        assert (whole - y).abs().max() > 1e-2 * whole.abs().max()
    got = results[0]["moe-layer-" + mode]
    for a, b in [(got["y"], y), (got["dx"], tx.grad)] + [(got["dp"][k], p[k].grad) for k in p]:
        b = b.detach().numpy()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    for rank, r in results.items():  # each rank routed and capped its own rows
        rows = slice(r["moe-layer-" + mode]["coords"][0] * 4 // dp,
                     (r["moe-layer-" + mode]["coords"][0] + 1) * 4 // dp)
        for k in ("experts", "kept"):
            np.testing.assert_array_equal(r["moe-layer-" + mode]["routes"][k],
                                          routes[k][rows].numpy())


def test_placements_put_the_specs_blocks_on_each_rank(spawned):
    """On (2,2): each rank's local shard is the block the spec gives it (an
    entry of two mesh axes splits its dim major axis first)."""
    results = spawned((2, 2))
    sizes = {"data": 2, "model": 2}
    for r in results.values():
        coords = dict(zip(("data", "model"), r["placements"]["coords"]))
        for (axes, shape, kw), (spec, local) in zip(PLACEMENT_SPECS, r["placements"]["locals"]):
            full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
            idx = []
            for dim, entry in enumerate(spec):
                group = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
                block, n = 0, 1
                for a in group:
                    block, n = block * sizes[a] + coords[a], n * sizes[a]
                size = shape[dim] // n
                idx.append(slice(block * size, (block + 1) * size))
            np.testing.assert_array_equal(local, full[tuple(idx)])
    specs = [s for s, _ in results[0]["placements"]["locals"]]
    assert specs[0] == ("model", "data") and specs[4] == (None, ("data", "model"), None, None)


def test_sharded_bf16_accumulation_matches_unsharded_and_jax(spawned):
    """One step on (1, 2) with `accum_dtype=torch.bfloat16` through the
    policy path (each micro-batch's gradient placed as its parameter in
    fp32, then rounded and summed in bf16): the loss to 1e-5 relative of
    the port's unsharded bf16 step and to 1e-4 of the JAX step with
    `accum_dtype=jnp.bfloat16`, the grad norm to 1e-2 relative of both,
    every clipped gradient within 1e-2 of its leaf's max abs of the
    unsharded one's (the two bf16 roundings of a sum may part where the
    tp split reorders the fp32 partial sums)."""
    got = spawned((1, 2))[0]["qwen3-8b-bf16-accum"]
    case = _bf16_accum_case()
    cfg, _, _, _, params, _ = _model_inputs("qwen3-8b")
    batch = case["batches"][0]
    tcfg = t_reduced(t_get_arch("qwen3-8b"))
    opt = make_optimizer("adamw", lr=LR)
    tp = params_from_jax(params, dtype=torch.float32, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    state = {"params": tp, "opt": opt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    step = build_train_step(tcfg, opt, microbatches=2, compute_dtype=torch.float32,
                            accum_dtype=torch.bfloat16)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})

    def fp32_loss(cfg_, params_, batch_, policy, **k):
        return j_loss_fn(cfg_, params_, batch_, policy, compute_dtype=jnp.float32, **k)
    saved = j_train_step.loss_fn
    j_train_step.loss_fn = fp32_loss  # read when the step is traced, at its first call
    try:
        jopt = j_make_optimizer("adamw", lr=LR)
        jstep = jax.jit(j_train_step.build_train_step(cfg, J_NULL, jopt, microbatches=2,
                                                      accum_dtype=jnp.bfloat16))
        jp = jax.tree.map(jnp.asarray, params)
        _, jm = jstep({"params": jp, "opt": jopt.init(jp), "step": jnp.zeros((), jnp.int32)},
                      {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        j_train_step.loss_fn = saved
    np.testing.assert_allclose(got["loss"][0], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["loss"][0], float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"][0], float(m["grad_norm"]), rtol=1e-2)
    np.testing.assert_allclose(got["grad_norm"][0], float(jm["grad_norm"]), rtol=1e-2)
    want = [p.grad.numpy() for p in tree_leaves(state["params"])]
    assert len(got["grads"][0]) == len(want)
    for i, (a, b) in enumerate(zip(got["grads"][0], want)):
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max() + 1e-12, i


def test_one_rank_mesh_matches_unsharded(spawned):
    """At a (1,1) mesh (what one card runs): 3 sharded fp32 steps against
    the unsharded ones, and prefill + one decode step with the DTensor
    parameters against the plain ones."""
    got = spawned((1, 1))[0]["one"]
    np.testing.assert_allclose(got["sharded"], got["plain"], rtol=1e-6)
    for a, b in zip(got["params_sharded"], got["params_plain"]):
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30)
    for a, b in zip(got["served"]["sharded"], got["served"]["plain"]):
        np.testing.assert_array_equal(a, b)


def test_driver_under_torchrun_trains_sharded(spawned):
    """`torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu
    --reduced --tp 2`: a (1, 2) mesh; its bf16 losses within 2e-3 of the
    driver's on one process, the same seed and batches."""
    from repro_torch.launch import train

    got = spawned("torchrun")["losses"]
    args = train.parser().parse_args(_driver_argv([]))
    want = train.run_spmd(t_reduced(t_get_arch("qwen3-8b")), args)["losses"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_checkpoint_saved_on_2x2_resumes_on_2x1(spawned):
    """The driver saves the whole state on (2,2) at step 2 and resumes it on
    (2,1): the resumed step's bf16 loss is the (2,2) run's within 2e-3."""
    saved = spawned((2, 2))[0]["driver-save"]
    resumed = spawned("resume")[0]["driver-resume"]
    assert len(saved) == 3 and len(resumed) == 1
    np.testing.assert_allclose(resumed[0], saved[2], rtol=2e-3)
