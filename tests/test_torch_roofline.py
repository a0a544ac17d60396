"""The port's roofline (`repro_torch.roofline`) and the attention kernels as
ops with a shape-only path (`repro_torch.kernels.ops`), on the CPU:

  * `model_flops` equals the reference's for every arch x shape, and
    `roofline_terms` gives the reference's keys and values on the same cost
    and hardware;
  * `OpCounter`'s FLOPs are exact for a product and a tanh chain (as
    tests/test_roofline.py holds the HLO walker), views charge no bytes,
    and the peak holds the made storages until they are freed;
  * ring bytes for an all-gather, a reduce-scatter and an all-reduce of
    known size on a fake-group mesh (in a subprocess: the group is the
    process's);
  * on the meta device the kernel ops' FLOPs equal `chip_smoke.attention_bound`'s
    count for one causal document a row, a window and a non-causal call, and
    on tensors with data the pairs the ids make visible;
  * the fake outputs' shapes and dtypes equal the plain version's on the CPU;
  * the recurrences' loops (`counter.scan`): one Mamba, mLSTM and sLSTM
    layer at S = 64 (mLSTM chunks of 4), forward and forward + backward,
    counted on meta with SAMPLE iterations of each loop run and scaled
    against the whole loop: FLOPs and HBM bytes equal, the peak within 2%;
    matmul FLOPs equal to the same layer's on CPU tensors, where the hint
    runs the whole loop and leaves the outputs bit for bit.
"""
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, SHAPES_BY_NAME, get_arch
from repro.roofline import analysis as j_analysis
from repro_torch.configs import get_arch as t_get_arch, reduced as t_reduced
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_mask, packed_attention_ref
from repro_torch.models.model import apply_layer, init_layer
from repro_torch.roofline import counter
from repro_torch.roofline.analysis import H100, model_flops, roofline_terms
from repro_torch.roofline.counter import OpCounter
from repro_torch.train.optimizer import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_the_reference(arch):
    for shape in SHAPES_BY_NAME.values():
        for attn in (True, False):
            assert model_flops(t_get_arch(arch), shape, include_attention=attn) == \
                j_analysis.model_flops(get_arch(arch), shape, include_attention=attn)


def test_roofline_terms_match_the_reference():
    cost = SimpleNamespace(flops=3.1e15, matmul_flops=3.0e15, hbm_bytes=2.2e12,
                           collective_bytes={"all-gather": 4e10, "all-reduce": 6e10},
                           total_collective_bytes=1e11)
    hw = j_analysis.Hardware("h100", H100.peak_flops, H100.hbm_bw, H100.ici_bw, H100.hbm_bytes)
    for name in ("qwen3-8b", "grok-1-314b"):
        for shape in SHAPES_BY_NAME.values():
            want = j_analysis.roofline_terms(cost, 256, get_arch(name), shape, hw=hw)
            assert roofline_terms(cost, 256, t_get_arch(name), shape) == want
    assert roofline_terms(cost, 256)["bound"] == "compute"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_flops_exact_for_a_product_and_a_tanh_chain(device):
    x = torch.ones(128, 256, device=device)
    w = torch.ones(256, 256, device=device)
    with OpCounter() as c:
        a = x @ w
    assert c.flops == c.matmul_flops == 2 * 128 * 256 * 256
    assert c.hbm_bytes == (128 * 256 + 256 * 256 + 128 * 256) * 4
    with OpCounter() as c:
        y = x
        for _ in range(4):
            y = torch.tanh(y @ w)
    assert c.matmul_flops == 4 * 2 * 128 * 256 * 256
    assert c.flops == c.matmul_flops + 4 * 128 * 256  # one a tanh result element
    with OpCounter() as c:
        y.sum()
    assert c.flops == 128 * 256  # one a reduced element
    del a


def test_views_charge_no_bytes_and_the_peak_holds_live_storages():
    x = torch.ones(64, 64)
    with OpCounter() as c:
        v = x.view(4096).reshape(64, 64).t()[:, :8].unsqueeze(0)
    assert c.hbm_bytes == 0 and c.peak_bytes == 0 and sum(c.calls.values()) >= 4
    del v
    with OpCounter() as c:
        a = x * 2  # 16 KiB made
        b = a + 1  # 16 KiB more: both live
        del a
        d = b.exp()  # a is gone: still two live
        d.add_(1)  # in place: nothing made
    assert c.peak_bytes == 2 * 64 * 64 * 4
    assert c.live_bytes == 2 * 64 * 64 * 4
    assert c.hbm_bytes == 3 * 2 * 64 * 64 * 4 + 2 * 64 * 64 * 4
    del b, d
    assert c.live_bytes == 0


RING = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch.roofline.counter import OpCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
full = torch.empty(1024, 256, dtype=torch.bfloat16, device="meta")
out = {}
for name, src, dst in (("all-gather", [Shard(0)], [Replicate()]),
                       ("reduce-scatter", [Partial()], [Shard(0)]),
                       ("all-reduce", [Partial()], [Replicate()])):
    d = (distribute_tensor(full, mesh, src) if name == "all-gather"
         else DTensor.from_local(full, mesh, src, run_check=False))
    with OpCounter() as c:
        d.redistribute(mesh, dst)
    out[name] = [dict(c.collective_bytes), c.hbm_bytes]
print("RESULT " + json.dumps(out))
"""


def test_ring_bytes_on_a_fake_group_mesh():
    """A (1024, 256) bf16 tensor (512 KiB) over 4 ranks: an all-gather and a
    reduce-scatter move 3/4 of it a rank, an all-reduce twice that."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", RING], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))[7:])
    full = 1024 * 256 * 2
    assert got == {"all-gather": [{"all-gather": full * 3 / 4}, 0.0],
                   "reduce-scatter": [{"reduce-scatter": full * 3 / 4}, 0.0],
                   "all-reduce": [{"all-reduce": 2 * full * 3 / 4}, 0.0]}


PEAK = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch.roofline.counter import OpCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
full = torch.empty(1024, 256, dtype=torch.bfloat16, device="meta")
out = {}
for name, src, dst in (("all-gather", [Shard(0)], [Replicate()]),
                       ("reduce-scatter", [Partial()], [Shard(0)]),
                       ("all-reduce", [Partial()], [Replicate()])):
    d = (distribute_tensor(full, mesh, src) if name == "all-gather"
         else DTensor.from_local(full, mesh, src, run_check=False))
    with OpCounter() as c:
        kept = d.redistribute(mesh, dst)
        out[name] = [c.peak_bytes, c.live_bytes, kept.to_local().untyped_storage().nbytes()]
        del kept
        out[name].append(c.live_bytes)
print("RESULT " + json.dumps(out))
"""


def test_collective_outputs_count_in_the_peak():
    """A redistribution's output is memory the rank holds: while it lives
    the counter holds its bytes (an all-gather's and an all-reduce's whole
    512 KiB, a reduce-scatter's quarter), the peak at least that, and
    nothing once it is freed. A gradient that a collective forms (the
    backward of a gathered weight) so counts in a sharded step's peak."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", PEAK], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))[7:])
    full = 1024 * 256 * 2
    for name, size in (("all-gather", full), ("reduce-scatter", full // 4), ("all-reduce", full)):
        peak, live, kept, after = got[name]
        assert kept == size and live == size and peak >= size and after == 0, (name, got[name])


def _one_document_ids(B, Sq, Sk):
    seg_q, seg_k = torch.ones((B, Sq), dtype=torch.int32), torch.ones((B, Sk), dtype=torch.int32)
    pos_q = torch.arange(Sq, dtype=torch.int32).repeat(B, 1)
    pos_k = torch.arange(Sk, dtype=torch.int32).repeat(B, 1)
    return seg_q, seg_k, pos_q, pos_k


@pytest.mark.parametrize("Sq,Sk,causal,window", [(300, 300, True, None), (300, 300, True, 64),
                                                 (40, 300, False, None), (300, 300, False, 64)])
def test_kernel_op_flops_on_meta_equal_attention_bound(Sq, Sk, causal, window):
    """One document a row: the meta count's assumption, against
    `attention_bound`'s count over the mask of those ids."""
    cs = _chip_smoke()
    B, H, K, dh = 2, 8, 2, 64
    ids = _one_document_ids(B, Sq, Sk)
    mask = attention_mask(*ids, causal=causal, window=window)
    q = torch.empty((B, Sq, H, dh), device="meta", requires_grad=True)
    k, v = (torch.empty((B, Sk, K, dh), device="meta", requires_grad=True) for _ in range(2))
    meta_ids = [t.to("meta") for t in ids]
    with OpCounter() as c:
        out = ops.packed_attention(q, k, v, *meta_ids, causal=causal, window=window)
        out.backward(torch.empty_like(out))
    fwd, bwd = (c.flops_by_op[f"repro_torch.packed_attn_{d}"] for d in ("fwd", "bwd"))
    qt = torch.empty((B, Sq, H, dh), dtype=torch.bfloat16)
    assert fwd == cs.attention_bound(qt, mask, 2, 0)[2]
    assert bwd == cs.attention_bound(qt, mask, 5, 0)[2]
    assert c.attention_flops == fwd + bwd
    assert ops.visible_pairs(*meta_ids, causal=causal, window=window) == int(mask.sum())


def test_visible_pairs_on_data_count_the_ids():
    """Packed documents and padding: the pairs these ids make visible."""
    seg = torch.tensor([[1] * 5 + [2] * 7 + [0] * 4, [3] * 16], dtype=torch.int32)
    pos = torch.tensor([list(range(5)) + list(range(7)) + [0] * 4, list(range(16))],
                       dtype=torch.int32)
    for causal, window in ((True, None), (True, 3), (False, None)):
        want = int(attention_mask(seg, seg, pos, pos, causal=causal, window=window).sum())
        assert ops.visible_pairs(seg, seg, pos, pos, causal=causal, window=window) == want
    assert ops.visible_pairs(seg, seg, pos, pos, causal=True, window=None) == \
        15 + 28 + 136


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_outputs_match_the_plain_version(dtype):
    """The ops' fake outputs on meta tensors have the shapes and dtypes of
    the plain version's on the CPU (forward, lse, and the three gradients)."""
    B, Sq, Sk, H, K, dh = 2, 24, 40, 4, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, n, dh)).astype(np.float32)).to(dtype)
               for S, n in ((Sq, H), (Sk, K), (Sk, K)))
    ids = _one_document_ids(B, Sq, Sk)
    ref = packed_attention_ref(q, k, v, *ids, causal=False)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    packed_attention_ref(qg, kg, vg, *ids, causal=False).sum().backward()
    m = [t.to("meta") for t in (q, k, v, *ids)]
    out, lse = torch.ops.repro_torch.packed_attn_fwd(*m, False, None, None, True)
    assert (out.shape, out.dtype) == (ref.shape, ref.dtype)
    assert (lse.shape, lse.dtype) == ((B, H, Sq), torch.float32)
    _, empty = torch.ops.repro_torch.packed_attn_fwd(*m, False, None, None, False)
    assert empty.shape == (0,)
    grads = torch.ops.repro_torch.packed_attn_bwd(*m[:3], out, lse, out, *m[3:], False, None,
                                                  None)
    for g, want in zip(grads, (qg.grad, kg.grad, vg.grad)):
        assert (g.shape, g.dtype, g.device.type) == (want.shape, want.dtype, "meta")


def test_cpu_tensors_take_the_plain_version():
    """`packed_attention` on the CPU is the plain version, with no op call."""
    q = torch.randn(1, 8, 2, 16)
    k = v = torch.randn(1, 8, 2, 16)
    ids = _one_document_ids(1, 8, 8)
    with OpCounter() as c:
        out = ops.packed_attention(q, k, v, *ids)
    assert not [n for n in c.calls if n.startswith("repro_torch.")]
    torch.testing.assert_close(out, packed_attention_ref(q, k, v, *ids), rtol=0, atol=0)


# one layer of each recurrent mixer: (arch, period position)
LOOPS = {"mamba": ("jamba-1.5-large-398b", 1), "mlstm": ("xlstm-1.3b", 0),
         "slstm": ("xlstm-1.3b", 7)}
LOOP_S = 64


def _loop_layer(mixer, device, train, sample, *, count=True):
    """One layer of `mixer` at LOOP_S positions (2 rows, documents of 20
    and 44) on `device`, counted (with `count`) with `counter.SAMPLE` =
    `sample` (None: the whole loop) -> (counter, output, gradients)."""
    arch, pos = LOOPS[mixer]
    cfg = t_reduced(t_get_arch(arch), mlstm_chunk=4)
    spec = cfg.period[pos]
    g = torch.Generator().manual_seed(0)
    p = tree_map(lambda w: w.to(device).requires_grad_(train),
                 init_layer(g, cfg, spec, dtype=torch.float32, device="cpu"))
    x = torch.randn((2, LOOP_S, cfg.d_model), generator=g).to(device)
    seg = torch.tensor([[1] * 20 + [2] * 44] * 2, dtype=torch.int32, device=device)
    pos_ = torch.arange(LOOP_S, dtype=torch.int32, device=device).repeat(2, 1)
    md = {"segment_ids": seg, "positions": pos_, "abs_positions": pos_, "causal": True}
    saved = counter.SAMPLE
    counter.SAMPLE = sample if sample is not None else 10 ** 9
    try:
        with (OpCounter() if count else contextlib.nullcontext()) as c, \
                torch.set_grad_enabled(train):
            out, _ = apply_layer(cfg, spec, p, x, md)
            grads = torch.autograd.grad(out.square().sum(), tree_leaves(p)) if train else ()
    finally:
        counter.SAMPLE = saved
    return c, out, grads


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
@pytest.mark.parametrize("mixer", list(LOOPS))
def test_scaled_loops_count_as_the_whole_loop(mixer, train):
    whole, _, _ = _loop_layer(mixer, "meta", train, None)
    scaled, _, _ = _loop_layer(mixer, "meta", train, counter.SAMPLE)
    assert scaled.scaled_loops > 0 and whole.scaled_loops == 0
    assert scaled.flops == pytest.approx(whole.flops, rel=1e-12)
    assert scaled.matmul_flops == pytest.approx(whole.matmul_flops, rel=1e-12)
    assert scaled.hbm_bytes == pytest.approx(whole.hbm_bytes, rel=1e-12)
    assert scaled.peak_bytes == pytest.approx(whole.peak_bytes, rel=2e-2)
    cpu, _, _ = _loop_layer(mixer, "cpu", train, counter.SAMPLE)
    assert cpu.matmul_flops == whole.matmul_flops


@pytest.mark.parametrize("mixer", list(LOOPS))
def test_the_loop_hint_leaves_real_tensors_alone(mixer):
    """On CPU tensors, counted or not, the layer runs its whole loop: the
    same outputs and gradients bit for bit."""
    _, out, grads = _loop_layer(mixer, "cpu", True, counter.SAMPLE)
    _, out0, grads0 = _loop_layer(mixer, "cpu", True, counter.SAMPLE, count=False)
    assert torch.equal(out, out0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0, strict=True))
