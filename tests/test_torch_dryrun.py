"""The port's dry-run (`repro_torch.launch.dryrun`) on the CPU.

Reduced cells (`cfg_overrides`, as the reference's `run_cell` allows) on a
small fake-group mesh in place of the production one, (2, 2) or (2, 2, 2),
run in one subprocess (the fake default process group is the process's): a
train, a prefill and a decode cell of qwen3-8b, a decode cell of qwen3-moe,
a VLM train cell (M-RoPE), the MoE layer over the (pod, data) axes, and an
encoder-decoder's train and decode cells (reduced whisper-medium), and the
recurrent families' cells (reduced xlstm-1.3b decode, and train_4k over a
whole period with its sLSTM layer; reduced jamba prefill_32k over Mamba
layers and an attention layer) are `ok` with the record's keys, their
`compute_s` is the counted flops over the H100's peak, and the counted
attention FLOPs are the kernel ops' visible pairs. The recurrent train and
prefill cells finish in seconds because their loops run SAMPLE iterations
and are counted whole (`roofline.counter.scan`). `skipped` follows each
config's `shape_skips`, and the CLI prints its summary line. The train
cells of grok-1 and jamba (above 5e10 parameters) accumulate gradients in
bf16, every other arch's in float32, as the reference's dry-run.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES_BY_NAME, get_arch
from repro_torch.launch.dryrun import accum_dtype_for, run_cell
from repro_torch.roofline.analysis import H100

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 512}
MOE = {**SMALL, "n_experts": 4, "moe_top_k": 2, "moe_d_ff": 64}
ENC_DEC = {**SMALL, "n_enc_layers": 2}
CELLS = {
    "train": ("qwen3-8b", "train_4k", SMALL, False),
    "prefill": ("qwen3-8b", "prefill_32k", SMALL, False),
    "decode": ("qwen3-8b", "decode_32k", SMALL, False),
    "moe-decode": ("qwen3-moe-30b-a3b", "decode_32k", MOE, False),
    "vlm": ("qwen2-vl-7b", "train_4k", {**SMALL, "mrope_sections": (2, 3, 3)}, False),
    "moe-pod": ("qwen3-moe-30b-a3b", "prefill_32k", MOE, True),
    "enc-dec": ("whisper-medium", "train_4k", ENC_DEC, False),
    "enc-dec-decode": ("whisper-medium", "decode_32k", ENC_DEC, False),
    "recurrent": ("xlstm-1.3b", "decode_32k", SMALL, False),
    # one period each: 7 mLSTM layers and an sLSTM; Mamba + MoE, Mamba, Mamba
    # + MoE, attention
    "recurrent-train": ("xlstm-1.3b", "train_4k", {**SMALL, "n_layers": 8}, False),
    "hybrid-prefill": ("jamba-1.5-large-398b", "prefill_32k", {**MOE, "n_layers": 4}, False),
}
MESHES = {False: (4, {"data": 2, "model": 2}), True: (8, {"pod": 2, "data": 2, "model": 2})}
OK_CELLS = list(CELLS)
SCALED_CELLS = ("recurrent-train", "hybrid-prefill")
RUN = r"""
import json, sys
from repro_torch.launch import dryrun
# small meshes of the production ones' axes
dryrun.production_mesh_shape = lambda multi_pod=False: (
    ((2, 2, 2), ("pod", "data", "model")) if multi_pod else ((2, 2), ("data", "model")))
cells = json.loads(sys.argv[1])
out = {name: dryrun.run_cell(arch, shape, cfg_overrides=over, multi_pod=mp, microbatches=2)
       for name, (arch, shape, over, mp) in cells.items()}
print("RESULT " + json.dumps(out))
"""
KEYS = {"arch", "shape", "multi_pod", "tag", "status", "accum_dtype", "n_devices", "mesh",
        "trace_s", "memory_analysis", "counter", "roofline", "hbm_model"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "bound", "flops_per_device",
                 "matmul_flops_per_device", "hbm_bytes_per_device",
                 "collective_bytes_per_device", "collective_breakdown", "model_flops_total",
                 "model_flops_per_device", "useful_flops_ratio", "roofline_fraction"}


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def records():
    r = subprocess.run([sys.executable, "-c", RUN, json.dumps(CELLS)], env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))[7:])


@pytest.mark.parametrize("name", OK_CELLS)
def test_reduced_cell_has_the_record(records, name):
    rec = records[name]
    assert rec["status"] == "ok", rec.get("reason")
    assert KEYS <= set(rec) and ROOFLINE_KEYS <= set(rec["roofline"])
    assert (rec["n_devices"], rec["mesh"]) == MESHES[CELLS[name][3]]
    assert rec["accum_dtype"] == "float32"
    mem, hbm = rec["memory_analysis"], rec["hbm_model"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert hbm["per_device_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert hbm["capacity_bytes"] == int(H100.hbm_bytes) and hbm["fits"]
    c, r = rec["counter"], rec["roofline"]
    assert r["compute_s"] == c["flops"] / H100.peak_flops
    assert r["memory_s"] == c["hbm_bytes"] / H100.hbm_bw
    assert r["collective_s"] == c["total_collective_bytes"] / H100.ici_bw
    assert r["flops_per_device"] == c["flops"] >= c["matmul_flops"] > 0
    assert c["total_collective_bytes"] > 0  # FSDP gathers, tp reduces


def test_train_cell_counts_the_kernel_ops_visible_pairs(records):
    """train_4k at 256 x 4096 on (2, 2): 2 micro-batches of 128 rows, 64 a
    data rank, 2 of the 4 heads a model rank; each layer runs the forward
    kernel twice (remat) and the backward once: 2 + 2 + 5 products of 2 *
    dh per visible pair (one causal document a row) and head."""
    S = 4096
    pairs = 64 * S * (S + 1) // 2
    want = 2 * 2 * 9 * 2 * 16 * 2 * pairs  # micro-batches, layers, products, 2*dh, heads
    assert records["train"]["counter"]["attention_flops"] == want
    assert records["decode"]["counter"]["attention_flops"] == 0  # decode attends densely


def test_unported_families_and_meshes_name_their_item(records):
    """No family is left unported: the recurrent cell, once `not_ported`,
    runs `ok` with the record's keys."""
    rec = records["recurrent"]
    assert rec["status"] == "ok", rec.get("reason")
    assert KEYS <= set(rec) and ROOFLINE_KEYS <= set(rec["roofline"])


@pytest.mark.parametrize("name", SCALED_CELLS)
def test_recurrent_cells_count_their_loops_scaled(records, name):
    """The train_4k and prefill_32k cells ran their loops in part (every
    layer's, each micro-batch's), the decode cell's one-position steps
    whole."""
    layers = CELLS[name][2]["n_layers"]
    assert records[name]["counter"]["scaled_loops"] >= layers
    assert records["recurrent"]["counter"]["scaled_loops"] == 0


def test_skipped_follows_shape_skips():
    for arch in ASSIGNED_ARCHS:
        for shape in get_arch(arch).shape_skips:
            rec = run_cell(arch, shape)
            assert rec["status"] == "skipped"
            assert rec["reason"] == get_arch(arch).shape_skips[shape]
    assert any(get_arch(a).shape_skips for a in ASSIGNED_ARCHS)
    assert set(SHAPES_BY_NAME) >= {s for a in ASSIGNED_ARCHS for s in get_arch(a).shape_skips}


def test_cli_prints_the_summary(tmp_path):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-8b",
                        "--shape", "long_500k", "--both-meshes", "--out", str(tmp_path)],
                       env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[-1] == "[dryrun] done ok=0 skip=2 not_ported=0 fail=0"
    assert json.loads((tmp_path / "qwen3-8b__long_500k__pod2__baseline.json").read_text())[
        "status"] == "skipped"


ACCUM = r"""
import json
from repro_torch.launch import dryrun
built = []
def build(cfg, opt, **kw):  # the step the cell would run: its accumulation type, then stop
    built.append(str(kw["accum_dtype"]))
    raise NotImplementedError("stopped before the step")
dryrun.build_train_step = build
recs = [dryrun.run_cell(a, "train_4k", multi_pod=mp)
        for a in ("grok-1-314b", "jamba-1.5-large-398b", "qwen3-8b") for mp in (False, True)]
print("RESULT " + json.dumps({"records": [(r["arch"], r["multi_pod"], r["accum_dtype"])
                                          for r in recs],
                              "built": built}))
"""


def test_train_records_accumulate_in_bf16_above_5e10_parameters():
    """grok-1's and jamba's train_4k records on both production meshes
    say bfloat16, and their step is built with it; qwen3-8b's say float32
    (the reference: bf16 where `param_count()` > 5e10). The steps stop
    when built: the records' memory is PERF.md's full run."""
    r = subprocess.run([sys.executable, "-c", ACCUM], env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))[7:])
    assert got["records"] == [[a, mp, t] for a, t in (("grok-1-314b", "bfloat16"),
                                                      ("jamba-1.5-large-398b", "bfloat16"),
                                                      ("qwen3-8b", "float32"))
                              for mp in (False, True)]
    assert got["built"] == ["torch.bfloat16"] * 4 + ["torch.float32"] * 2
    for arch in ASSIGNED_ARCHS:
        big = get_arch(arch).param_count() > 5e10
        assert accum_dtype_for(get_arch(arch)) == (torch.bfloat16 if big else torch.float32)
        assert big == (arch in ("grok-1-314b", "jamba-1.5-large-398b"))
