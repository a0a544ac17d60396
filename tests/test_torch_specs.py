"""The port's `launch.specs` against the JAX `repro.launch.specs`, on the CPU.

For every `ASSIGNED_ARCHS` x shape cell at full size: each batch, parameter
and decode-cache spec has the reference's shape and dtype (the port's meta
tensors against the reference's `ShapeDtypeStruct`s), and its spec tuple
equals the reference's on stand-in (16, 16) and (2, 16, 16) meshes (sizes
only), under the dry-run's policy for the cell (the port's
`policy_for_cell` against the reference's rule). The port keeps a list of
layers where the reference stacks them per period position: layer
j*P + pos is row j of stack pos, and its shape and spec are the stack's
without the leading "layers" entry, which is never sharded.
"""
import functools

import pytest

from repro.configs import ASSIGNED_ARCHS, SHAPES_BY_NAME, get_arch
from repro.launch import specs as j_specs
from repro.parallel import sharding as j_sharding
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.launch import specs
from repro_torch.launch.dryrun import policy_for_cell

MESHES = {"pod1": ((16, 16), ("data", "model")), "pod2": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """A mesh of sizes only, for both packages' rules."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _j_policy(mesh, cfg, shape):
    """The reference dry-run's `policy_for_cell` (`src/repro/launch/dryrun.py:29`)."""
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= mesh.shape[a]
    policy = j_sharding.policy_for_mesh(mesh, shard_batch=shape.global_batch >= dp)
    tp = policy.tp
    attn = ("heads" if tp and cfg.n_heads % tp == 0
            else "head_dim" if tp and cfg.head_dim % tp == 0 else None)
    return policy.replace(attn_shard=attn)


@functools.lru_cache(maxsize=None)
def _j_params(arch):
    return j_specs.serve_param_specs(get_arch(arch))


def _walk(port, ref, stacked=False):
    """(port leaf, reference leaf, in a stack) pairs: a list of layers in the
    port against the reference's tuple of per-period-position stacks."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (set(port), set(ref))
        for k in port:
            yield from _walk(port[k], ref[k], stacked)
    elif isinstance(port, list):
        assert isinstance(ref, tuple) and len(port) % len(ref) == 0
        for i, layer in enumerate(port):
            yield from _walk(layer, ref[i % len(ref)], True)
    else:
        yield port, ref, stacked


def _assert_shapes(port, ref):
    pairs = list(_walk(port, ref))
    assert pairs
    for p, r, stacked in pairs:
        assert p.device.type == "meta"
        want = tuple(r.shape[1:] if stacked else r.shape)
        assert tuple(p.shape) == want and str(p.dtype).split(".")[-1] == str(r.dtype), (p, r)


def _assert_specs(port, ref):
    pairs = list(_walk(port, ref))
    assert pairs
    for p, r, stacked in pairs:
        assert isinstance(p, tuple)
        r = tuple(r)
        if stacked:
            assert r[0] is None
            r = r[1:]
        assert p == r, (p, r)


@pytest.fixture
def spec_tuples(monkeypatch):
    """The reference's shardings as spec tuples (its mesh is sizes only)."""
    monkeypatch.setattr(j_sharding.ShardingPolicy, "sharding_for",
                        lambda self, axes, shape: tuple(self.spec_for(axes, shape)))
    monkeypatch.setattr(j_specs, "NamedSharding", lambda mesh, spec: tuple(spec))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_match_the_reference(arch, spec_tuples):
    jcfg, cfg = get_arch(arch), t_get_arch(arch)
    jparams, jaxes = _j_params(arch)
    params, axes = specs.serve_param_specs(cfg)
    _assert_shapes(params, jparams)
    for name, shape in SHAPES_BY_NAME.items():
        if shape.kind == "decode":
            batch, jbatch = specs.decode_batch_specs(cfg, shape), j_specs.decode_batch_specs(
                jcfg, shape)
            cache, jcache = specs.cache_specs(cfg, shape), j_specs.cache_specs(jcfg, shape)
            _assert_shapes(cache, jcache)
        else:
            with_labels = shape.kind == "train"
            batch = specs.train_batch_specs(cfg, shape, with_labels=with_labels)
            jbatch = j_specs.train_batch_specs(jcfg, shape, with_labels=with_labels)
        _assert_shapes(batch, jbatch)
        for mesh_shape, names in MESHES.values():
            mesh = FakeMesh(mesh_shape, names)
            jpol, pol = _j_policy(mesh, jcfg, shape), policy_for_cell(mesh, cfg, shape)
            for field in ("dp_axes", "tp_axis", "shard_batch", "attn_shard", "fsdp",
                          "decode_kv_seq_shard", "expert_parallel", "seq_parallel"):
                assert getattr(pol, field) == getattr(jpol, field), field
            _assert_specs(specs.batch_shardings(pol, batch),
                          j_specs.batch_shardings(jpol, jbatch))
            if shape.kind == "decode":
                _assert_specs(specs.cache_shardings(pol, cache),
                              j_specs.cache_shardings(jpol, jcache))
            if shape.kind != "train":
                _assert_specs(specs.param_shardings(pol, params, axes),
                              j_specs.param_shardings(jpol, jparams, jaxes))


def test_input_specs_give_the_state_batch_and_cache_placements():
    """`input_specs` of each kind on a stand-in (16, 16) mesh: the train
    state's placements are `sharding_for_state`'s, and every other leaf's
    are its spec's."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.train.train_step import sharding_for_state

    cfg = t_get_arch("qwen3-8b")
    mesh = FakeMesh(*MESHES["pod1"])
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = SHAPES_BY_NAME[name]
        pol = policy_for_cell(mesh, cfg, shape)
        args, placements, opt = specs.input_specs(cfg, shape, pol)
        assert (opt is not None) == (shape.kind == "train")
        assert len(args) == len(placements) == (3 if shape.kind == "decode" else 2)
        assert placements[-1]["tokens"] == [Shard(0), Replicate()]
        if shape.kind == "train":
            assert placements[0] == sharding_for_state(pol, cfg, opt)[0]
            assert args[0]["params"]["embed"].device.type == "meta"
        if shape.kind == "decode":
            # 32768 slots over the model axis; the batch of 128 over data
            assert placements[1][0]["mixer"]["k"] == [Shard(0), Shard(1)]
            assert placements[1][0]["mixer"]["pos"] == [Shard(0), Shard(1)]
