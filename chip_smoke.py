"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out FILE.json]

Phases, in one process; any failure exits nonzero:
  1. build   every CUDA kernel from src/repro_torch/kernels/csrc with nvcc,
             and check in the SASS that the bf16 kernels, forward and
             backward, run on the tensor cores (HGMMA instructions), the
             head_dim 256 backward's dK/dV and dQ kernels and the head_dim
             80 and 64 forward, dK/dV and dQ kernels each on its own, and
             that the fp32 forward (at every head width) and the fp32
             backward's dK/dV and dQ kernels (at head_dim 64, 80, 128 and
             256) run TF32 tensor-core products (HMMA ... TF32); no
             function of any library spills in its ptxas report;
  2. kernel  hold each kernel against its plain PyTorch version on the card
             (bf16 tensor-core forward: serving shape and a packed shape,
             timed also with every visible tile masked, and a windowed
             shape with padding rows; fp32 3xTF32 tensor-core forward: a
             ragged shape; the backward kernels,
             bf16 tensor-core and fp32 3xTF32 tensor-core (there also at
             every split of its two loops, and in turn with SDPA's
             backward over 10 rounds), at the same shapes and
             at the shape of each micro-batch the train paths launch them
             on) and time it beside
             its bound (fp32 also against 3xTF32), the plain version and
             one PyTorch library call;
             every backward is also run twice and held bit for bit;
  3. family  the same, forward and backward, bf16 and fp32, at the heads of
             gemma3-1b and gemma3-4b (head_dim 256), h2o-danube-1.8b (80),
             llama2-7b (GQA group 1), qwen2.5-7b (group 7),
             qwen3-moe-30b-a3b (group 8), grok-1-314b (group 6) and
             jamba-1.5-large-398b (64/8 heads), on
             1 x 4096 packed documents at each arch's window;
  4. fp32    the fp32 parity paths: reduced qwen3-8b, gemma3-1b and
             h2o-danube-1.8b at their real head widths in fp32 on the card
             (the 3xTF32 forward, timed at each path's 2 x 256 batch, one
             launch per layer, and the 3xTF32 backward in one train step)
             against the CPU;
  5. forward full-width, 36-layer qwen3-8b (random bf16 weights from a seed):
             packed forward + loss over synthetic batches, one kernel launch
             per layer, and the Eq. 1 micro-batch predictor fit on the times;
  6. serve   the serving path: packed prefill of 4 x 2048-token prompts
             through the bf16 kernel, then 64 greedy decode steps over a
             2112-slot cache, checked against the packed forward;
  7. train   the training path: full-width qwen3-8b cut to 8 layers (fp32
             masters + AdamW, bf16 compute, remat) trained for 20 steps by
             the port's spmd driver, through the bf16 forward and backward
             kernels, with the Eq. 1 fit and the Detector on the step times;
             then step 0 again with bf16 gradient accumulation (the
             reference's `accum_dtype` above 5e10 parameters), its
             gradients within 2e-2 of each leaf's max abs of the fp32 step
             0's, its peak memory beside the fp32 run's;
  8. pipeline the ResiHP runtime: the same model (8 layers) under a dp=2,
             pp=2, tp=2 plan (8 plan devices on the one card) trained for 12
             steps by the port's pipeline driver, with a fail-stop injected
             at step 4 and a fail-slow at step 8: detect -> adapt -> recover
             -> resume, each checked step's loss held to `loss_fn` on the
             same parameters and batch, exact launches per step, the
             migration identity, and Algorithm 1's migrator
             (`ProgressAwareMigrator` on the fail-slow adaptation's
             `migrator_kwargs`, executor (0, 1) at speed 0.3, delta 0)
             placing one more iteration on the final plan: at least one
             chunk moved, the loss within 1e-5 of the unplaced one;
  9. checkpoint the pipeline driver's restart on the fp32 parity model (6
             steps straight against 3 + save + restart + 3) and a Fig. 8b
             recovery from the checkpoint onto the card, bit for bit;
             `RestartCostModel.from_manifest` prices that checkpoint and a
             small one with a bf16 leaf (the manifest's bytes, no more than
             the leaf files'), beside the disk's save and restore GB/s;
     cluster the port's cluster simulator (host Python and numpy, no
             torch): the simulator golden replayed with both engines, and
             the reference example's 256-device run (four policies, 160
             iterations) held to the throughputs the CPU gives, rel 1e-9;
 10. dense family at full width: gemma3-1b (26 layers, tied embeddings)
             serves 4 x 2048 + 64 greedy steps through 1024-slot rings that
             wrap (first and last step held to the packed forward), trains
             10 steps, and runs 4 pipeline steps at dp1/pp2; h2o-danube-1.8b
             (24 layers, head_dim 80) trains 10 steps; llama2-7b and
             qwen2.5-7b (full depth) serve 4 x 2048 + 16 steps; llama2-7b
             cut to 8 layers runs phase 8's faults under the paper's small
             plan (tp4 dp2 pp2, 16 plan devices);
 11. MoE     the fp32 parity path of reduced qwen3-moe-30b-a3b (head_dim 128,
             4 experts, top-2) with the full config's Adafactor (bf16
             momentum, the spmd trainer's stacks), routes equal on the card
             and the CPU; one full-width MoE layer run twice, bit for bit;
             qwen3-moe-30b-a3b at full depth (48 layers, 30.53 B) serves
             4 x 2048 + 16 greedy steps (exactly 48 launches, prefill held
             to a packed forward on the same batch, so the same drops; a
             first decode step from a prefill that drops nothing held to a
             packed forward that drops nothing, whose fed token takes the
             decode step's experts, their route agreement gated; the main
             path's first decode step held to that one on the rows its
             prefill dropped nothing of; decode ms beside its
             weight-streaming bound), trains cut to 3 layers (10 steps)
             and runs phase 8's faults cut to 3 layers; grok-1-314b at
             full width cut to 4 layers serves the same;
 12. VLM and encoder-decoder: the kernels in whisper-medium's regimes
             (16/16 heads, head_dim 64, bf16 and fp32, forward and backward:
             the non-causal encoder at 4 x 1500 and 1 x 4096 packed clips,
             the causal decoder at 1 x 1024, cross-attention at 1 x 1024
             over 1 x 4096 keys, a transcript without its clip included, and
             at 4 x 64 over 4 x 1500); the fp32 parity paths of reduced
             qwen2-vl-7b (head_dim 128, M-RoPE) and whisper-medium (head_dim
             64); qwen2-vl-7b (28 layers) serves 4 x 2048 prompts opening
             with 512 vision embeddings + 16 greedy steps and trains cut to
             8 layers (10 steps of 2 x 1 x 4096, a 1024-embedding vision
             span a row); whisper-medium (24 + 24 layers) serves 4 clips of
             1500 frames with 64-token prompts + 64 greedy steps over a
             448-slot self cache and constant cross caches, and trains 10
             steps of 2 x (4096 frames, 1024 decoder positions); exact
             launches (72 a whisper pass) by source and by regime;
 13. recurrent: the fp32 parity paths of reduced xlstm-1.3b (4 mLSTM chunks
             a row) and reduced jamba-1.5-large-398b (fp32 attention kernels,
             Adafactor, routes equal on the card and the CPU); jamba's Mamba
             + dense layer (1.02 B) forward and backward at 1 x 4096, twice
             bit for bit, gradients held to the layer in fp32;
             xlstm-1.3b (48 layers) serves 4 x 2048 + 64 greedy steps (the
             first held to the port's fp32 decode step: the reference's
             mLSTM decode drops the conv window) and trains cut to one
             period (8 layers);
             jamba-1.5-large-398b cut to 4 layers serves 4 x 2048 + 16 steps
             (1 attention launch a prefill, the MoE serve checks); each with
             device time, busy share, launches per layer and step, and its
             loops' share of the device time;
 14. sharding: a one-rank NCCL process group and its (1, 1) (data, model)
             mesh: phase 8's model, plan and fail-stop through the pipeline
             driver for 6 steps with every stage on its own mesh (the
             one-rank (1, 1) mesh), losses equal to phase 8's first 6 bit
             for bit, launches a step equal, the migration identity, step
             seconds, busy share and peak memory beside phase 8's, each
             step's hand-off bytes (Fig. 7's rule: none on one rank) beside
             `p2p_cost_bytes`; the
             sharded train step (DTensor state placed by the
             sharding rules, the kernels through `local_map`) on the fp32
             parity model against the unsharded step (3 steps, parameters
             to 1e-5 of each leaf's max, bit for bit or not); full-width
             qwen3-8b cut to 8 layers, 5 steps through
             `build_train_step(..., policy=...)`: step 0's loss held to
             `loss_fn`, every loss to the train phase's on the same seed and
             batches, exact launches a step, zero plain calls, step seconds,
             busy share and peak memory beside the train phase's; the
             int8 error-feedback compressor over that step's gradients
             (seconds and GB/s beside the HBM bound, one leaf's codes and
             scales equal to the CPU's); the same for the VLM and
             encoder-decoder families: the fp32 parity of reduced
             qwen2-vl-7b and whisper-medium (real head widths), then
             qwen2-vl-7b cut to 8 layers and whisper-medium at full depth,
             3 steps each of the multimodal phase's batches, held to that
             phase's losses; serving on the mesh at full depth (qwen3-8b,
             qwen2-vl-7b, whisper-medium: prefill, then 8 greedy steps, the
             cache placed by `launch.specs.place_cache`, the cross caches
             too) with the unsharded serve phases' tokens, prefill logits
             within 2e-2 and decode logits within 5e-2 of theirs, decode ms
             a step beside theirs; qwen3-moe-30b-a3b cut to 3 layers on a
             (1, 1, 1) (pod, data, model) mesh, one step through the MoE
             layer's EP path and one through its TP path, each held to the
             unsharded step's loss and routes; the recurrent families: the
             fp32 parity of reduced xlstm-1.3b and jamba-1.5-large-398b
             (Adafactor, weight seed 1), serving of xlstm-1.3b (48 layers)
             and jamba cut to 4 layers held to phase 13's tokens and logits
             (decode's busy share profiled), xlstm-1.3b cut to one period (7
             mLSTM layers and an sLSTM) trained 2 steps of 1 x 1024 on the
             mesh and unsharded (losses and gradients equal), jamba's Mamba
             layer forward and backward on the mesh against unsharded, and
             each recurrent mixer's kernels a layer on the mesh and not;
 15. roofline: the op counter (`roofline.counter`) on the meta device over
             the steps timed above (qwen3-8b's 8-layer train step, its
             4 x 2048 prefill, whisper-medium's train step), each's counted
             FLOPs and bytes, H100 bound (`roofline.analysis.H100`, the
             table this script's peaks read), measured seconds, bound share,
             and predicted against measured peak memory; one real qwen3-8b
             train step counted on the card, its matmul FLOPs equal to the
             meta count and its attention FLOPs to `attention_bound`'s
             visible pairs; xlstm-1.3b's one-period train step at 1 x 256
             counted on meta (its loops run a few iterations, counted as
             all) and on the card (whole), matmul FLOPs equal; the dry-run
             of qwen3-8b decode_32k and of xlstm-1.3b long_500k on the
             (16, 16) fake-group mesh in subprocesses, status `ok`.
Prints the card's name and power limit first, a `kernels` JSON line before
the last, and as the last line {"ok": true, "device": {...}}. Imports no JAX
and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))  # the port, beside this script
from repro_torch.roofline.analysis import H100  # noqa: E402  (the port's one table of peaks)

PEAK_BF16_FLOPS = H100.peak_flops  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = H100.peak_fp32_flops  # H100 SXM fp32 outside the tensor cores
PEAK_3XTF32_FLOPS = H100.peak_tf32_flops / 3  # fp32 products as three TF32 products
PEAK_BYTES = H100.hbm_bw  # H100 SXM HBM3
SERVE_B, PROMPT, NEW_TOKENS = 4, 2048, 64
FORWARD_BATCHES, FIT_BATCHES = 12, 8
# training: 8 layers of full-width qwen3-8b fit one 80 GB card in fp32
# masters + fp32 gradients + AdamW m and v (16 bytes per parameter)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_FIT = 8, 20, 2, 8
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCHES = 4096, 2, 2
TRAIN_PROFILED_STEP = 1  # after the warm-up step 0; Eq. 1 and the Detector skip it
# the ResiHP runtime: a model under a dp x pp x tp plan whose plan devices
# all map onto the card, each replica 2 micro-batches of 1 x 4096 a step; a
# fail-stop, then a fail-slow, detected, adapted to, recovered from. qwen3-8b
# at the train phase's 8 layers: the engine accumulates each leaf's
# gradient in place inside the backward, so the fail-stop's repartition
# (4/4 -> 2/6) leaves a 6-layer + LM-head stage whose gradient exists once
# beside fp32 masters, AdamW m and v and both replicas' fp32 gradients
# (55.8 GB), where it once held a second copy and ran out of memory at
# 74.7 GB allocated on the 80 GB card. gemma3-1b at full depth runs dp1/pp2
# (its tied embeddings read by both stages), no fault; llama2-7b cut to 8
# layers runs the paper's small plan (Table 3: tp4 dp2 pp2, 16 plan devices)
# through the same faults.
PIPE_SEQ, PIPE_MICROBATCHES = 4096, 2
# qwen3-8b's run ends with Algorithm 1's migrator placing one more iteration
# on the final plan ("migrator": the executor whose speed is set, the speed,
# Algorithm 1's delta; at the fail-slow's own speeds and `run_pipeline`'s delta 1
# it moves nothing)
PIPE_SPECS = {
    "qwen3-8b": {"layers": 8, "plan": {"dp": 2, "pp": 2, "tp": 2}, "steps": 12,
                 "failstop": "4:5", "failslow": "8:1@0.3", "reconfigs": [4, 8],
                 "checked": (0, 4, 8, 11), "profiled": 2, "migrator": ((0, 1), 0.3, 0)},
    "gemma3-1b": {"layers": None, "plan": {"dp": 1, "pp": 2, "tp": 1}, "steps": 4,
                  "failstop": None, "failslow": None, "reconfigs": [], "checked": (0,),
                  "profiled": None},
    "llama2-7b": {"layers": 8, "plan": {"dp": 2, "pp": 2, "tp": 4}, "steps": 12,
                  "failstop": "4:9", "failslow": "8:1@0.3", "reconfigs": [4, 8],
                  "checked": (0, 4, 8, 11), "profiled": 2},
}
# the MoE family: qwen3-moe-30b-a3b (30.53 B) at 3 layers (2.49 B) under
# qwen3-8b's plan and faults (the fail-stop's repartition 2/1 -> 1/2, the
# fail-slow's TP 2 -> 1; at 4 layers it peaked at 83.13 GB of the card's
# 85.5e9 bytes); the engine trains on NLL alone, as the reference's
PIPE_SPECS["qwen3-moe-30b-a3b"] = {**PIPE_SPECS["qwen3-8b"], "layers": 3, "migrator": None}
PIPE_PLAN = PIPE_SPECS["qwen3-8b"]["plan"]  # the checkpoint phase's plan
# phase 14's pipeline on stage meshes: phase 8's model, plan and fail-stop
# for its first 6 steps, every stage on the one-rank (1, 1) mesh; its losses
# are held to phase 8's first 6 bit for bit
STAGE_MESH_SPEC = {**PIPE_SPECS["qwen3-8b"], "steps": 6, "failslow": None, "reconfigs": [4],
                   "checked": (), "profiled": 2, "migrator": None}
TOL_PIPE_LOSS_REL, TOL_MIGRATION = 1e-3, 1e-5
# the dense family: each arch's attention widths on its packed train shape
FAMILY_KERNEL_ARCHS = ("gemma3-1b", "gemma3-4b", "h2o-danube-1.8b", "llama2-7b", "qwen2.5-7b",
                       "qwen3-moe-30b-a3b", "grok-1-314b",  # MoE: GQA groups 8 and 6
                       "jamba-1.5-large-398b")  # 64/8 heads: its one attention layer a period
FAMILY_SEQ = 4096
FAMILY_TRAIN_STEPS, FAMILY_TRAIN_FIT = 10, 6
PAPER_NEW_TOKENS = 16
PARITY_ARCHS = ("qwen3-8b", "gemma3-1b", "h2o-danube-1.8b")  # head_dim 128, 256, 80
CKPT_STEPS, CKPT_INTERVAL, TOL_RESTART = 6, 3, 1e-5
# the cluster phase: the simulator golden's run (tests/golden/simulator_golden.json)
# and examples/cluster_failures.py's 256-device run, whose simulated samples/s
# per policy the CPU gives as below (both packages, numpy 2.0.2)
GOLDEN_SIM = {"cfg": dict(dp=2, pp=2, tp=2, n_layers=8, n_microbatches=4, seq_len=2048,
                          noise=0.01, seed=0),
              "scenario": ("fig10_mixed", 3.0), "iters": 60,
              "policy_kwargs": dict(plan_overhead_fixed=0.25)}
EXAMPLE_SIM = {"cfg": dict(dp=4, pp=16, tp=4, n_layers=80, n_microbatches=6, seq_len=8192,
                           seed=0),
               "scenario": "example_mixed", "iters": 160,
               "samples_per_s": {"resihp": 30.388704916614678, "recycle+": 29.12211984724184,
                                 "oobleck+": 25.72355733059813, "recycle": 26.56963612667855}}
TOL_SIM_REL = 1e-9  # the golden test's own bound
# the fp32 parity path: reduced qwen3-8b at the real head width
PARITY_SEQ, PARITY_BATCH, PARITY_MICROBATCHES = 256, 2, 2
TOL_BF16, TOL_FP32 = 2e-2, 1e-4
# the fp32 backward and SDPA's, timed in turn at the parity and ragged shapes
INTERLEAVE_ROUNDS, INTERLEAVE_ITERS = 10, 20
# the MoE family: qwen3-moe-30b-a3b serves at full depth (48 layers, 61.1 GB
# of bf16 weights) and trains cut to 3 layers (2.49 B: AdamW, which
# `optimizer_for` picks for the cut config); grok-1-314b serves at full
# width cut to 4 layers (21.29 B, 42.6 GB); its training waits for sharding
MOE_TRAIN_LAYERS, GROK_LAYERS = 3, 4
# bf16 end to end, 36 layers: prefill vs the packed forward differ only in
# the LM-head product's shape; the first decode step takes the dense cache
# path (bf16 scores) instead of the kernel (fp32 scores)
TOL_PREFILL_REL, TOL_DECODE_REL = 2e-2, 5e-2
# the least share of the fed token's experts (every MoE layer) on which a
# decode step and the packed forward agree: bf16 near-ties swap a few
# (qwen3-moe 0.986); a decode step routing by another rule would agree on
# about k / E of them
MOE_ROUTE_AGREEMENT_FLOOR = 0.9
# the VLM and encoder-decoder families: qwen2-vl-7b serves 4 x 2048 prompts
# whose first PROMPT / 4 positions are vision embeddings (the reference's
# S / 4) on a 16 x 32 grid, and trains cut to 8 layers (2.96 B: AdamW, 16
# bytes a parameter) on 1 x 4096 micro-batches whose first document opens
# with a 1024-embedding span on a 32 x 32 grid; whisper-medium (24 + 24
# layers) serves 4 clips of 1500 frames (30 s each) with 64-token prompts
# and 64 greedy steps over a 448-slot self cache (its published
# max_target_positions), and trains at full depth on rows of 4096 frames
# packed from 300-1500-frame clips and 1024 decoder positions
VLM_SERVE_GRID, VLM_TRAIN_VISION, VLM_TRAIN_GRID, VLM_TRAIN_LAYERS = (16, 32), 1024, (32, 32), 8
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_MAX_TARGET = 1500, 64, 448
WHISPER_TRAIN_FRAMES, WHISPER_CLIPS = 4096, (300, 1500)
MM_CROSS_QUERIES = 64  # the serving cross-attention's decoder prompt
# the recurrent families: xlstm-1.3b at full depth (48 layers: 42 mLSTM, 6
# sLSTM; 1.95 B) serves 4 x 2048 + 64 greedy steps and trains cut to its
# first period (AdamW, 16 bytes a parameter) for XLSTM_TRAIN_STEPS steps of
# one 1 x 4096 micro-batch (a full-depth step runs ~2.5 M eager launches,
# most of them the sLSTM loops forward, recomputed and backward); jamba-1.5-large-398b at full width
# cut to its period's first JAMBA_LAYERS layers (Mamba+MoE, Mamba+dense,
# Mamba+MoE, attention+dense: 23.02 B, 46 GB of bf16 weights) serves 4 x
# 2048 + 16 steps (its training waits for sharding: one MoE layer alone is
# 9.66 B, 155 GB of AdamW state); jamba's period position 1 (Mamba + dense,
# 1.02 B) trains forward and backward alone on 1 x 4096, its gradients held
# to the same layer in fp32 on the card to TOL_MAMBA_GRAD of a leaf's max
XLSTM_TRAIN_STEPS, JAMBA_LAYERS, TOL_MAMBA_GRAD = 2, 4, 2e-2
# its first step is its warm-up: 2 steps keep the whole command under 1000 s
# (with 3 and the sharding phase it took 978.1 s on an NVIDIA H100 80GB HBM3
# at 700 W); it trains cut to its first period, XLSTM_TRAIN_LAYERS layers (7
# mLSTM, 1 sLSTM): at full depth its 2 steps took 224 s of a 1332.3 s
# command once the recurrent sharding parts came (NVIDIA H100 80GB HBM3,
# 700 W), and its layers' training profiles run on 1 / XLSTM_TRAIN_SCALE of
# its positions
XLSTM_TRAIN_WARMUP, XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_SCALE = 1, 8, 8
RECURRENT = ("mamba", "mlstm", "slstm")
# each recurrent mixer's loop, by module and name (`loop_profile` times it alone)
SCANS = {"mamba": ("repro_torch.models.ssm", "selective_scan"),
         "mlstm": ("repro_torch.models.xlstm", "mlstm_scan"),
         "slstm": ("repro_torch.models.xlstm", "slstm_scan")}
ROUTER_GAP = 1e-5  # least gap between a router's k-th and (k+1)-th probability
# the sharding phase: 3 fp32 parity steps (2 x PARITY_SEQ) held to 1e-5 of a
# leaf's max, then full-width qwen3-8b (TRAIN_LAYERS) for SHARD_STEPS steps
# of the train phase's batches; the compressor's block
SHARD_PARITY_STEPS, SHARD_STEPS, TOL_SHARD, COMPRESS_BLOCK = 3, 5, 1e-5, 256
# then the same for the VLM and encoder-decoder families: the fp32 parity
# of each, qwen2-vl-7b cut to VLM_TRAIN_LAYERS and whisper-medium at full
# depth for SHARD_FAMILY_STEPS steps of the multimodal phase's batches (a
# warm-up, the profiled step, one more), and serving on the mesh at full
# depth (qwen3-8b too): prefill and SHARD_NEW_TOKENS greedy steps held to
# the unsharded serve phases (at 16 steps, with whisper's profile tracing
# host operators, the new parts took 124 s and the whole script 1052.1 s on
# an NVIDIA H100 80GB HBM3 at 700 W: cut to stay under its 1000 s target)
SHARD_FAMILIES, SHARD_FAMILY_STEPS, SHARD_NEW_TOKENS = ("qwen2-vl-7b", "whisper-medium"), 3, 8
# then the recurrent families: the fp32 parity of reduced xlstm-1.3b and
# jamba-1.5-large-398b, serving on the mesh (xlstm-1.3b at full depth, jamba
# cut to JAMBA_LAYERS), xlstm-1.3b cut to one period (7 mLSTM layers and an
# sLSTM) trained SHARD_RECURRENT_STEPS steps of 1 x SHARD_XLSTM_SEQ on the
# mesh and unsharded, and jamba's Mamba layer forward and backward on the mesh
SHARD_RECURRENT_STEPS, SHARD_XLSTM_SEQ = 2, 512
# phase 15 counts that xlstm cut's step at 1 x ROOFLINE_XLSTM_SEQ on meta (its
# loops scaled) and on the card (whole)
ROOFLINE_XLSTM_SEQ = 256
LOOP_PROFILE_SCALE = 4  # `loop_profile` runs a layer on a quarter of the path's positions


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us_by_kernel(fn, iters, attempts=3):
    """Device time in us of each kernel name over `iters` calls of fn (after
    one warm-up call), from torch.profiler. Host time between launches does
    not count. A trace with no device event at all, which the profiler
    returns now and then (after its warning that it "clears events at the
    end of each cycle"), is taken again, `attempts` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
        if us:
            break
    return us


def device_ms(fn, iters, names=()):
    """Device time per call of fn() in ms: the kernels whose names contain
    any of `names`, or every kernel the call launches. Unlike `cuda_ms`,
    host time between launches does not count."""
    us = sum(t for key, t in device_us_by_kernel(fn, iters).items()
             if not names or any(n in key for n in names))
    if us <= 0:
        raise AssertionError(f"the profiler saw no device time{f' for {names}' if names else ''}")
    return us / 1e3 / iters


def library_timing(fn, iters):
    """(device ms per call, the names of the kernels it launched) of a
    yardstick PyTorch call: which backend SDPA picks shows in the names, and
    its time has moved up to 2.5x between processes on the same shapes."""
    us = device_us_by_kernel(fn, iters)
    if sum(us.values()) <= 0:
        raise AssertionError("the profiler saw no device time for the yardstick call")
    return sum(us.values()) / 1e3 / iters, sorted(name[:80] for name in us)


def attention_bound(q, mask, products, moved_bytes):
    """Least time (ms) for packed attention on these inputs, and what bounds it.

    Operations: `products` matrix products of 2 * dh per visible (query,
    key) pair and head, counted from this run's mask (forward: QK^T and PV;
    backward: QK^T again, dP = dO V^T, dV, dK, dQ). Bytes: `moved_bytes`, each
    input read once and each output written once.
    """
    H, dh = q.shape[2], q.shape[3]
    flops = 2.0 * products * dh * H * float(mask.sum())
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, moved_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, moved_bytes


def bound_3xtf32(flops, moved_bytes, ms):
    """An fp32 kernel's bound against 495 / 3 TFLOP/s (its products as
    3xTF32 on the tensor cores) or the bytes, and its share of `ms`."""
    bound = max(flops / PEAK_3XTF32_FLOPS, moved_bytes / PEAK_BYTES) * 1e3
    return {"bound_3xtf32_ms": bound, "bound_3xtf32_share": bound / ms}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_case(name, out, ref, tol, seg, no_key=None):
    """Max abs error of a forward output; fails outside `tol` or where a
    padding row (or a row of `no_key`, which sees no key) is not exactly 0."""
    err = float((out.float() - ref.float()).abs().max())
    bad = ((out.float() - ref.float()).abs() > tol + tol * ref.float().abs()).sum().item()
    if bad or not math.isfinite(err):
        raise AssertionError(f"{name}: {bad} elements outside {tol} (max abs err {err})")
    pad = seg == 0 if no_key is None else no_key
    if pad.any() and not bool((out[pad] == 0).all()):
        raise AssertionError(f"{name}: padding rows or rows with no visible key are not exactly 0")
    return err


def all_tiles_masked(fn):
    """fn, run with every visible tile of the wrapper's tile map marked as
    needing the mask (code 1): the bf16 kernel without its unmasked tiles."""
    import repro_torch.kernels.packed_flash_attn as pfa

    def run():
        tile_map = pfa.tile_map
        pfa.tile_map = lambda *a, **kw: tile_map(*a, **kw).clamp_(max=1)
        try:
            return fn()
        finally:
            pfa.tile_map = tile_map
    return run


def case_ids(seg, pos, keys):
    """(seg_q, seg_k, pos_q, pos_k) of a case: the keys' ids are the
    queries' unless `keys` gives their own (cross-attention)."""
    seg_k, pos_k = keys if keys is not None else (seg, pos)
    return seg, seg_k, pos, pos_k


def kernel_case(name, q, k, v, seg, pos, tol, *, time_it, window=None, time_masked=True,
                time_splits=False, causal=True, keys=None):
    """Kernel vs plain version on one input (with `keys`, the keys' own
    (seg, pos): cross-attention); optionally timed (and, for the bf16 kernel
    with `time_masked`, timed again with every tile masked; for the fp32
    kernel with `time_splits`, held to the plain version and timed at every
    split of its key walk up to 16). Rows with no visible key must be
    exactly 0. Returns a row."""
    from repro_torch.kernels.packed_flash_attn import (
        FWD_TF32, SM90, _sm_count, fwd_splits, kernel_for, packed_flash_attention, pair_rows,
        tile_map, tile_sizes)
    from repro_torch.kernels.ref import attention_mask, packed_attention_ref

    ids = case_ids(seg, pos, keys)
    args = (q, k, v, *ids)
    kw = {"causal": causal, "window": window}
    dh = q.shape[-1]
    kern = kernel_for(q.dtype, dh)
    out = packed_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = packed_attention_ref(*args, **kw)
    codes = tile_map(*ids, *tile_sizes(q.dtype, dh), **kw)
    mask = attention_mask(*ids, **kw)
    no_key = ~mask.any(-1)
    row = {"case": name, "kernel": kern.source, "shape": list(q.shape),
           "kv_heads": k.shape[2], "keys": k.shape[1], "dtype": str(q.dtype), "window": window,
           "causal": causal, "head_dim": dh,
           "max_abs_err": check_case(name, out, ref, tol, seg, no_key), "tol": tol,
           "padding_rows": int((seg == 0).sum()), "rows_without_key": int(no_key.sum()),
           "tiles": list(tile_sizes(q.dtype, dh)),
           "skipped_tile_fraction": float((codes == 0).float().mean()),
           "unmasked_tile_fraction": float((codes == 2).float().mean()),
           # the narrow bf16 kernel's mode: two map rows a CTA (1) or one (0)
           "pair": pair_rows(kern, q.shape[0], q.shape[2], codes.shape[1],
                            _sm_count(q.device.index))}
    if time_it:
        # q, k, v and the int32 seg/pos of both sides read, out written
        bound, by, flops, moved = attention_bound(
            q, mask, 2, nbytes(q, k, v, out, *ids))
        # ms: the kernels' own device time; wrapper_*: the whole call (tile
        # map + launch), on the device and on CUDA events (host gaps count)
        call = lambda: packed_flash_attention(*args, **kw)  # noqa: E731
        row.update(ms=device_ms(call, 20, kern.names), wrapper_device_ms=device_ms(call, 20),
                   wrapper_event_ms=cuda_ms(call, iters=20),
                   plain_ms=device_ms(lambda: packed_attention_ref(*args, **kw), 3),
                   bound_ms=bound, bound_by=by, flops=flops, bytes=moved)
        # yardstick only: one PyTorch call computing the same function
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bmask = mask[:, None]
        row["library_ms"], row["library_kernels"] = library_timing(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask, enable_gqa=True), 10)
        row["library_call"] = "torch.nn.functional.scaled_dot_product_attention(bool mask, enable_gqa)"
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / row["ms"] / 1e9
        if q.dtype == torch.float32:  # the ceiling this design answers to: 3xTF32
            row.update(bound_3xtf32(flops, moved, row["ms"]))
        if kern.source == FWD_TF32.source:  # the split of its key walk, chosen and forced
            B, H = q.shape[0], q.shape[2]
            Sqp, Skp = codes.shape[1] * kern.block_q, codes.shape[2] * kern.block_k
            row["splits"] = fwd_splits(kern, B, H, Sqp, Skp, _sm_count(q.device.index))
            if time_splits:
                row["ms_by_splits"] = {}
                for s in (1, 2, 4, 8, 16):
                    with forced("fwd_splits", s):
                        check_case(f"{name} split {s}", call(), ref, tol, seg, no_key)
                        row["ms_by_splits"][s] = device_ms(call, 20, kern.names)
        if kern.source == SM90.source and time_masked:  # what the unmasked tiles (code 2) save
            masked = all_tiles_masked(call)
            check_case(f"{name} all tiles masked", masked(), ref, tol, seg, no_key)
            row["all_masked_ms"] = device_ms(masked, 20, kern.names)
            row["all_masked_wrapper_event_ms"] = cuda_ms(masked, iters=20)
    log("kernel", json.dumps(row))
    return row


def backward_case(name, q, k, v, seg, pos, tol, *, time_it, window=None, time_splits=False,
                  causal=True, keys=None):
    """Backward kernel vs autograd through the plain version (with `keys`,
    the keys' own (seg, pos): cross-attention); optionally timed (with
    `time_splits`, the fp32 backward also at every split of its two loops,
    and in turn with SDPA's backward, round by round, for their spread).
    Rows with no visible key must give lse +inf and dq exactly 0, keys no
    query sees dk and dv exactly 0. Returns a row."""
    from repro_torch.kernels.packed_flash_attn import (
        backward_kernel_for, backward_tile_maps, packed_flash_attention,
        packed_flash_attention_backward)
    from repro_torch.kernels.ref import attention_mask, packed_attention_ref_backward

    ids = case_ids(seg, pos, keys)
    kw = {"causal": causal, "window": window}
    g = torch.Generator(device=q.device)
    g.manual_seed(4321)
    d_out = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    out, lse = packed_flash_attention(q, k, v, *ids, **kw, return_lse=True)
    call = lambda: packed_flash_attention_backward(  # noqa: E731
        q, k, v, out, lse, d_out, *ids, **kw)
    grads = call()
    again = call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{name}: a second backward launch differs bit for bit")
    del again
    plain = lambda: packed_attention_ref_backward(  # noqa: E731
        q, k, v, d_out, *ids, **kw)
    ref = plain()
    errs = {gname: grad_error(name, gname, a, b, tol)
            for gname, a, b in zip(("dq", "dk", "dv"), grads, ref)}
    mask = attention_mask(*ids, **kw)
    no_key, no_query = ~mask.any(-1), ~mask.any(1)
    if not (bool(torch.isposinf(lse.transpose(1, 2)[no_key]).all())
            and bool((grads[0][no_key] == 0).all())
            and all(bool((x[no_query] == 0).all()) for x in grads[1:])):
        raise AssertionError(f"{name}: a row with no visible key (lse, dq) or a key no query "
                             "sees (dk, dv) is not exactly +inf / 0")
    kern = backward_kernel_for(q.dtype, q.shape[-1])
    padded, (codes, codes_dq) = backward_tile_maps(kern, *ids, **kw)
    # the wrapper's split of each loop over CTAs (the sum kernels run only then)
    B, H, K = q.shape[0], q.shape[2], k.shape[2]
    Sqp, Skp = padded[0].shape[1], padded[1].shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = kern.splits(B, H, K, Sqp, Skp, sms)
    launched = [n for n in kern.names if max(splits) > 1 or "_sum_" not in n]
    row = {"case": name, "kernel": kern.source, "shape": list(q.shape), "kv_heads": k.shape[2],
           "keys": k.shape[1], "dtype": str(q.dtype), "window": window, "causal": causal,
           "head_dim": q.shape[-1], "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs, "tol_of_max_ref": tol,
           "padding_rows": int((seg == 0).sum()), "rows_without_key": int(no_key.sum()),
           "keys_without_query": int(no_query.sum()), "tiles": [kern.block_q, kern.block_k],
           "splits": splits, "skipped_tile_fraction": float((codes == 0).float().mean())}
    if kern.dq_tiles is not None:
        row.update(dq_tiles=list(kern.dq_tiles),
                   dq_skipped_tile_fraction=float((codes_dq == 0).float().mean()),
                   unmasked_tile_fraction=float((codes == 2).float().mean()))
    if time_it:
        # q, k, v, out, d_out, lse and seg/pos read; dq, dk, dv written
        bound, by, flops, moved = attention_bound(
            q, mask, 5, 2 * nbytes(q, k, v) + nbytes(out, d_out, lse, *ids))
        us = device_us_by_kernel(call, 10)
        by_name = {kname: sum(t for key, t in us.items() if kname in key) / 1e3 / 10
                   for kname in launched}
        if not all(by_name.values()):  # also when the other source's kernels ran
            raise AssertionError(f"{name}: the profiler saw no device time for {by_name}")
        if kern.split_rule == "kv":  # what the split buys, at every split
            row["ms_by_splits"] = {s: sum(by_name.values()) if s == splits[0] else
                                   forced_split_ms(call, kern, "kv_splits", s)
                                   for s in range(1, H // K + 1) if (H // K) % s == 0}
        if kern.split_rule == "tf32" and time_splits:
            row["ms_by_splits"] = tf32_split_ms(call, kern, splits, H // K * Sqp // kern.block_q,
                                                Skp // kern.dq_tiles[1], tol, ref)
        # each kernel's share of the backward (whisper's regimes: the delta pass,
        # dK/dV and dQ, each a launch of its own or folded into another)
        total = sum(by_name.values())
        row["share_by_kernel"] = {kname: t / total for kname, t in by_name.items()}
        row.update(ms=total, ms_by_kernel=by_name,
                   wrapper_event_ms=cuda_ms(call, iters=10),
                   plain_ms=device_ms(plain, 2), bound_ms=bound, bound_by=by, flops=flops,
                   bytes=moved)
        if q.dtype == torch.float32:  # the ceiling this design answers to: 3xTF32
            row.update(bound_3xtf32(flops, moved, row["ms"]))
        # yardstick only: SDPA's backward on the same bool mask, its gradients of
        # q, k and v alone (torch.autograd.grad: none is added into a .grad)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
        dot = d_out.transpose(1, 2)
        library = lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
        row["library_ms"], row["library_kernels"] = library_timing(library, 10)
        row["library_call"] = ("torch.nn.functional.scaled_dot_product_attention(bool mask, "
                               "enable_gqa) backward by torch.autograd.grad")
        if time_splits:  # the kernel and SDPA in turn, each round's time: their spread
            rounds = interleaved_ms({"kernel": (call, launched), "library": (library, None)})
            row["interleaved_rounds"] = rounds
            row["interleaved"] = {name: {"min": min(ts), "median": float(np.median(ts)),
                                         "max": max(ts)} for name, ts in rounds.items()}
            row["interleaved_ratio"] = (row["interleaved"]["kernel"]["median"]
                                        / row["interleaved"]["library"]["median"])
        del o, qt, kt, vt, library
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["tflops"] = flops / row["ms"] / 1e9
    log("backward", json.dumps(row))
    return row


def interleaved_ms(calls, rounds=INTERLEAVE_ROUNDS, iters=INTERLEAVE_ITERS):
    """Device ms per call of each of `calls` (name -> (fn, the kernel names
    that count, or None for every kernel)), timed in turn, `iters` calls a
    round: each call's time in every round."""
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, (fn, knames) in calls.items():
            us = device_us_by_kernel(fn, iters)
            times[name].append(sum(t for key, t in us.items()
                                   if knames is None or any(n in key for n in knames))
                               / 1e3 / iters)
    return times


def grad_error(name, gname, got, ref, tol):
    """Max abs error of one gradient; fails above `tol` of max |ref| (or on NaN)."""
    err = float((got.float() - ref.float()).abs().max())
    limit = tol * float(ref.float().abs().max())
    if not err <= limit:
        raise AssertionError(f"{name}: {gname} max abs err {err} > {limit} ({tol} of max |ref|)")
    return err


@contextlib.contextmanager
def forced(rule, splits):
    """The split rule `rule` of `repro_torch.kernels.packed_flash_attn`
    returning `splits`, inside the block."""
    import repro_torch.kernels.packed_flash_attn as pfa

    chosen = getattr(pfa, rule)
    setattr(pfa, rule, lambda *a: splits)
    try:
        yield
    finally:
        setattr(pfa, rule, chosen)


def forced_split_ms(call, kern, rule, splits):
    """Device ms of `call` (every kernel of `kern`) with `rule` forced to
    return `splits`."""
    with forced(rule, splits):
        us = device_us_by_kernel(call, 10)
    return sum(t for key, t in us.items() if any(n in key for n in kern.names)) / 1e3 / 10


def tf32_split_ms(call, kern, chosen, kv_iters, dq_iters, tol, ref):
    """The fp32 backward's device ms at every power-of-two split of its dK/dV
    loop (the dQ split at the wrapper's choice) and of its dQ loop (the dK/dV
    split at its choice), up to each loop's iterations; each forced split's
    gradients are held to the plain version too."""
    def pows(n, c):
        return sorted({2 ** i for i in range(n.bit_length()) if 2 ** i <= n} | {c})
    res = {"kv": {}, "dq": {}}
    for side, values in (("kv", pows(kv_iters, chosen[0])), ("dq", pows(dq_iters, chosen[1]))):
        for s in values:
            splits = (s, chosen[1]) if side == "kv" else (chosen[0], s)
            res[side][s] = forced_split_ms(call, kern, "tf32_splits", splits)
            with forced("tf32_splits", splits):
                grads = call()
            for gname, a, b in zip(("dq", "dk", "dv"), grads, ref):
                grad_error(f"split {splits}", gname, a, b, tol)
    return res


def parity_model(cfg, index=0):
    """The fp32 parity path's model (reduced, at the real head width, and
    with M-RoPE at the real sections, which sum to its half) and its batch:
    packed documents; a VLM's rows open with a PARITY_SEQ / 8 vision span
    (at the reference's S / 4 the 384 labelled positions leave 0.13% of the
    gradient elements, 271 of them in the LM head, nonzero within 1e-4 of
    their leaf's max, over the train step check's 0.1% cap on elements held
    only to 2 lr; at S / 8, 0.06%), an encoder-decoder's hold PARITY_SEQ
    frames of clips and their transcripts in PARITY_SEQ / 4 decoder
    positions. An mLSTM model runs chunks of PARITY_SEQ / 4 positions, so
    its documents cross chunk ends and start mid-chunk. `index` picks the
    batch of the same seeded stream (0: the parity path's)."""
    from repro_torch.configs import reduced
    from repro_torch.data.multimodal import enc_dec_batch, vlm_batch
    from repro_torch.data.synth import SyntheticPackedDataset

    small = reduced(cfg, head_dim=cfg.head_dim, mrope_sections=cfg.mrope_sections,
                    mlstm_chunk=PARITY_SEQ // 4)
    if small.enc_dec:
        return small, enc_dec_batch(small, PARITY_SEQ, PARITY_SEQ // small.dec_ratio,
                                    PARITY_BATCH, seed=0,
                                    clip_frames=(PARITY_SEQ // 6, PARITY_SEQ // 2), index=index)
    if small.vlm:
        return small, vlm_batch(small, PARITY_SEQ, PARITY_BATCH, seed=0,
                                vision_len=PARITY_SEQ // 8, grid=(4, PARITY_SEQ // 32),
                                index=index, mu=4.0, sigma=0.8)
    return small, SyntheticPackedDataset(small, PARITY_SEQ, PARITY_BATCH, seed=0, mu=4.0,
                                         sigma=0.8).batch_at(index)


def attention_calls(cfg):
    """Attention layers one forward pass of `cfg`'s model runs, so kernel
    launches: every attention layer's self-attention (a Mamba or xLSTM
    layer runs none), and an encoder-decoder's encoder layers and each
    decoder layer's cross-attention too."""
    own = sum(spec.mixer == "attn" for spec in cfg.layer_specs())
    return own + (cfg.n_enc_layers + cfg.n_layers if cfg.enc_dec else 0)


def recurrent(cfg):
    """Whether some layer of `cfg` runs a recurrent mixer (a loop over
    positions or chunks: its profiles trace the device alone)."""
    return any(spec.mixer in RECURRENT for spec in cfg.layer_specs())


def row_ids(cfg, batch):
    """The segment ids of the rows whose logits a batch yields (the decoder's
    for an encoder-decoder)."""
    return batch["dec_segment_ids" if cfg.enc_dec else "segment_ids"]


def microbatch_cases(name, inputs, seg, pos, microbatches, tol, *, time_splits=False):
    """The backward kernel timed at each micro-batch of a packed batch: the
    launches a train step makes."""
    n = seg.shape[0] // microbatches
    return [backward_case(f"{name}{i}", *(x[i * n:(i + 1) * n] for x in (*inputs, seg, pos)),
                          tol, time_it=True, time_splits=time_splits)
            for i in range(microbatches)]


def per_launch(rows):
    """One row for the launches of `rows` (one per micro-batch): the mean
    of each time and bound (and of each kernel's time), the largest error,
    each micro-batch's times at every split where they were taken."""
    def mean(key):
        return sum(r[key] for r in rows) / len(rows)
    res = {k: mean(k) for k in ("ms", "plain_ms", "bound_ms", "library_ms", "wrapper_event_ms")
           if k in rows[0]}
    res.update(max_abs_err=max(r["max_abs_err"] for r in rows),
               bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
               shape=rows[0]["shape"], dtype=rows[0]["dtype"],
               microbatch_ms=[r["ms"] for r in rows],
               ms_by_kernel={n: sum(r["ms_by_kernel"][n] for r in rows) / len(rows)
                             for n in rows[0]["ms_by_kernel"]},
               splits=[r["splits"] for r in rows], tiles=rows[0].get("tiles"),
               dq_tiles=rows[0].get("dq_tiles"))
    if "bound_3xtf32_ms" in rows[0]:
        res.update(bound_3xtf32_ms=mean("bound_3xtf32_ms"),
                   bound_3xtf32_share=mean("bound_3xtf32_ms") / res["ms"])
    for key in ("ms_by_splits", "interleaved", "interleaved_ratio"):
        if key in rows[0]:
            res[key] = [r[key] for r in rows]
    return res


def kernel_phase(cfg, device):
    from repro_torch.data.synth import SyntheticPackedDataset

    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=device)
    g.manual_seed(1234)

    def qkv(B, S, dtype, heads=(H, K, K)):
        return tuple(torch.randn((B, S, h, dh), generator=g, device=device).to(dtype)
                     for h in heads)

    def one_doc(B, S):
        seg = torch.ones((B, S), dtype=torch.int32, device=device)
        return seg, torch.arange(S, dtype=torch.int32, device=device).repeat(B, 1)

    rows = {}
    seg, pos = one_doc(SERVE_B, PROMPT)
    inputs = qkv(SERVE_B, PROMPT, torch.bfloat16)
    rows["serving"] = kernel_case("serving", *inputs, seg, pos, TOL_BF16, time_it=True)
    rows["serving_bwd"] = backward_case("serving_bwd", *inputs, seg, pos, TOL_BF16, time_it=True)
    # the packed shape: the forward phase's batch 0
    packed = SyntheticPackedDataset(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    seg = torch.from_numpy(packed.batch_at(0)["segment_ids"]).to(device)
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=device).repeat(TRAIN_BATCH, 1)
    inputs = qkv(TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
    rows["packed"] = kernel_case("packed", *inputs, seg, pos, TOL_BF16, time_it=True)
    rows["packed_bwd"] = backward_case("packed_bwd", *inputs, seg, pos, TOL_BF16, time_it=True)
    # the train step's backward launches, one per micro-batch, on the batch of
    # the step the train phase profiles, so that the two times compare
    seg = torch.from_numpy(packed.batch_at(TRAIN_PROFILED_STEP)["segment_ids"]).to(device)
    rows["train_bwd"] = microbatch_cases("train_bwd_microbatch", inputs, seg, pos,
                                         TRAIN_MICROBATCHES, TOL_BF16)
    del inputs
    torch.cuda.empty_cache()
    seg, pos = one_doc(2, 1000)  # ragged, two documents, padding rows, a window
    seg[1, 300:] = 2
    pos[1, 300:] -= 300
    seg[1, 900:] = 0
    pos[1, 900:] = 0
    inputs = qkv(2, 1000, torch.bfloat16)
    rows["bf16_window_padding"] = kernel_case(
        "bf16_window_padding", *inputs, seg, pos, TOL_BF16, time_it=False, window=256)
    rows["bf16_window_padding_bwd"] = backward_case(
        "bf16_window_padding_bwd", *inputs, seg, pos, TOL_BF16, time_it=False, window=256)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's fp32 einsums
    log(f"fp32 check: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    seg, pos = one_doc(2, 777)
    seg[1, 500:] = 2  # a second document and a ragged edge
    pos[1, 500:] -= 500
    inputs = qkv(2, 777, torch.float32)
    rows["fp32_ragged"] = kernel_case("fp32_ragged", *inputs, seg, pos, TOL_FP32, time_it=True)
    rows["fp32_ragged_bwd"] = backward_case("fp32_ragged_bwd", *inputs, seg, pos, TOL_FP32,
                                            time_it=True, time_splits=True)
    # the parity path's shapes: its forward's batch, its train step's micro-batches
    small, batch = parity_model(cfg)
    seg = torch.from_numpy(batch["segment_ids"]).to(device)
    pos = torch.arange(PARITY_SEQ, dtype=torch.int32, device=device).repeat(PARITY_BATCH, 1)
    inputs = qkv(PARITY_BATCH, PARITY_SEQ, torch.float32,
                 (small.n_heads, small.n_kv_heads, small.n_kv_heads))
    rows["fp32_parity_bwd"] = microbatch_cases("fp32_parity_bwd_microbatch", inputs, seg, pos,
                                               PARITY_MICROBATCHES, TOL_FP32, time_splits=True)
    return rows


def arch_window(cfg):
    """The window of the arch's sliding-window layers, or None."""
    return cfg.window if any(s.attn_kind == "swa" for s in cfg.layer_specs()) else None


def family_kernel_phase(device):
    """Each dense arch's attention widths (head_dim 256 and 80; GQA groups 1
    and 7 at head_dim 128) on its packed train shape: 1 x 4096 of
    `SyntheticPackedDataset` documents, at the window of its local layers
    (and the bf16 backward at its global layers too, where it has both).
    The forward and backward kernels, bf16 and fp32, against their plain
    versions, each timed beside its bound, the plain version and SDPA."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synth import SyntheticPackedDataset

    g = torch.Generator(device=device)
    g.manual_seed(99)
    rows = {}
    for arch in FAMILY_KERNEL_ARCHS:
        cfg = get_arch(arch)
        H, K, dh, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, arch_window(cfg)
        raw = SyntheticPackedDataset(cfg, FAMILY_SEQ, 1, seed=0).batch_at(0)
        seg = torch.from_numpy(raw["segment_ids"]).to(device)
        pos = torch.arange(FAMILY_SEQ, dtype=torch.int32, device=device)[None]
        for dtype, tol, tag in ((torch.bfloat16, TOL_BF16, "bf16"),
                                (torch.float32, TOL_FP32, "fp32")):
            inputs = tuple(torch.randn((1, FAMILY_SEQ, h, dh), generator=g, device=device).to(dtype)
                           for h in (H, K, K))
            name = f"{arch}_{tag}"
            rows[name] = kernel_case(name, *inputs, seg, pos, tol, time_it=True, window=window,
                                     time_masked=False)
            rows[f"{name}_bwd"] = backward_case(f"{name}_bwd", *inputs, seg, pos, tol,
                                                time_it=True, window=window)
            if tag == "bf16" and window is not None and not all(
                    spec.attn_kind == "swa" for spec in cfg.layer_specs()):  # global layers too
                rows[f"{name}_global_bwd"] = backward_case(f"{name}_global_bwd", *inputs, seg,
                                                           pos, tol, time_it=True)
            del inputs
            torch.cuda.empty_cache()
    return rows


def reset_counts():
    from repro_torch.kernels.packed_flash_attn import (
        packed_flash_attention, packed_flash_attention_backward)

    for counts in (packed_flash_attention.launches, packed_flash_attention_backward.launches):
        for key in counts:
            counts[key] = 0


def read_counts():
    """Forward kernel launches by kernel source since the last `reset_counts`."""
    from repro_torch.kernels.packed_flash_attn import packed_flash_attention

    return dict(packed_flash_attention.launches)


def read_backward_counts():
    """Backward kernel launches by kernel source since the last `reset_counts`."""
    from repro_torch.kernels.packed_flash_attn import packed_flash_attention_backward

    return dict(packed_flash_attention_backward.launches)


def fp32_phase(cfg, device, *, optimizer="adamw", time_kernel=True, seed=0):
    """The fp32 parity path: a reduced `cfg` (real head width) in fp32 on
    the card, through the fp32 kernels, against the same model on the
    CPU: the forward kernel alone at the path's 2 x 256 batch and heads
    (timed, with `time_kernel`), the packed forward's logits, then one train
    step (2 micro-batches, remat, `optimizer`: Adafactor with bf16 momentum
    over the spmd trainer's stacks, as `optimizer_for` gives a full MoE
    config) through the forward and backward kernels, weights from `seed`:
    its loss, gradient norm and every gradient against the CPU's step
    (1e-4), and every parameter against the CPU optimizer's step from the
    same parameters and the card's gradients (1e-4, no element exempt).
    With MoE, each layer's routes on the card equal the CPU's, and no
    router of the CPU's forward or train step sees a near-tie (a top-k gap
    under ROUTER_GAP, which either device may break its own way)."""
    small, batch = parity_model(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's fp32 einsums
    kernel_row = fp32_kernel_row(cfg, small, batch, device) if time_kernel else None
    res = {"arch": cfg.arch_id, "layers": small.n_layers, "head_dim": small.head_dim,
           "window": arch_window(small), "optimizer": optimizer,
           **fp32_model_parity(small, batch, device, optimizer, seed), "kernel": kernel_row}
    log("fp32", json.dumps(res))
    return res


def fp32_kernel_row(cfg, small, batch, device):
    """The fp32 forward kernel alone at the parity path's batch and heads,
    and at its train step's micro-batches, timed."""
    g = torch.Generator(device=device)
    g.manual_seed(1234)
    qkv = tuple(torch.randn((PARITY_BATCH, PARITY_SEQ, h, small.head_dim), generator=g,
                            device=device) for h in (small.n_heads, small.n_kv_heads,
                                                     small.n_kv_heads))
    seg = torch.from_numpy(batch["segment_ids"]).to(device)
    pos = torch.arange(PARITY_SEQ, dtype=torch.int32, device=device).repeat(PARITY_BATCH, 1)
    kernel_row = kernel_case(f"{cfg.arch_id} fp32 parity", *qkv, seg, pos, TOL_FP32,
                             time_it=True, window=arch_window(small), time_splits=True)
    n = PARITY_BATCH // PARITY_MICROBATCHES  # and at the train step's micro-batches
    kernel_row["microbatches"] = [
        {key: row[key] for key in ("ms", "splits", "bound_ms", "max_abs_err", "library_ms")}
        for row in (kernel_case(f"{cfg.arch_id} fp32 parity microbatch {i}",
                                *(x[i * n:(i + 1) * n] for x in (*qkv, seg, pos)), TOL_FP32,
                                time_it=True, window=arch_window(small))
                    for i in range(PARITY_MICROBATCHES))]
    return kernel_row


def fp32_model_parity(small, batch, device, optimizer, seed=0):
    """The parity model's forward and one train step on the card against the
    CPU (`fp32_phase`)."""
    from repro_torch.kernels.packed_flash_attn import BWD_SM90, BWD_TF32, FWD_TF32, SM90
    from repro_torch.models.model import forward_train, init_params
    from repro_torch.train.optimizer import make_optimizer, tree_leaves, tree_map
    from repro_torch.train.train_step import build_train_step

    params = init_params(small, seed=seed, dtype=torch.float32, device="cpu")
    cpu_b = {k: torch.from_numpy(v) for k, v in batch.items()}
    gpu_b = to_device(batch, device)
    gpu_p = to_tree(params, device)
    moe = bool(small.n_experts)
    routes, gaps = {}, []
    with torch.inference_mode():
        reset_counts()
        with recording_routes(routes, "card") if moe else contextlib.nullcontext():
            logits_gpu, _ = forward_train(small, gpu_p, gpu_b, compute_dtype=torch.float32)
        torch.cuda.synchronize()
        counts = read_counts()
        with (recording_routes(routes, "cpu") if moe else contextlib.nullcontext(),
              recording_gaps(gaps) if moe else contextlib.nullcontext()):
            logits_cpu, _ = forward_train(small, params, cpu_b, compute_dtype=torch.float32)

    if moe and not all(torch.equal(a[k].cpu(), b[k]) for a, b in zip(routes["card"],
                                                                      routes["cpu"])
                       for k in ("experts", "kept")):
        raise AssertionError("fp32 MoE path: the card routes a token otherwise than the CPU")
    calls = attention_calls(small)
    if counts[FWD_TF32.source] != calls or counts[SM90.source] != 0:
        raise AssertionError(f"fp32 path launches {counts}, expected {calls} fp32 only")
    valid = torch.from_numpy(row_ids(small, batch) != 0)
    err = float((logits_gpu.cpu()[valid] - logits_cpu[valid]).abs().max())
    if not err <= TOL_FP32 * (1 + float(logits_cpu[valid].abs().max())):
        raise AssertionError(f"fp32 path: card vs CPU logits differ by {err}")

    stepped, lr = {}, 1e-3

    def make_opt():
        return make_optimizer(optimizer, lr=lr, momentum_dtype=(
            torch.bfloat16 if optimizer == "adafactor" else torch.float32))
    start = tree_map(lambda x: x.detach().clone(), params)  # the CPU's parameters before the step
    for where, dev, p, b in (("cpu", "cpu", params, cpu_b), ("card", device, gpu_p, gpu_b)):
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
        opt = make_opt()
        state = {"params": p, "opt": opt.init(p, period=len(small.period)),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = build_train_step(small, opt, microbatches=PARITY_MICROBATCHES,
                                compute_dtype=torch.float32)
        reset_counts()
        with recording_gaps(gaps) if moe and where == "cpu" else contextlib.nullcontext():
            state, metrics = step(state, b)
        if where == "card":
            torch.cuda.synchronize()
            train_counts, bwd_counts = read_counts(), read_backward_counts()
        stepped[where] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                        [x.grad.detach().cpu() for x in tree_leaves(p)],
                        [x.detach().cpu() for x in tree_leaves(p)])
    # the CPU optimizer's step from the same parameters with the card's own
    # (clipped) gradients: what the card's update must give
    opt = make_opt()
    card_grads = tree_map(lambda x: x.grad.detach().cpu(), gpu_p)
    opt.update(card_grads, opt.init(start, period=len(small.period)), start,
               torch.zeros((), dtype=torch.int32))
    p_want = tree_leaves(start)
    # per micro-batch and layer: forward + remat recompute, one backward
    want = {FWD_TF32.source: 2 * PARITY_MICROBATCHES * calls, SM90.source: 0}
    want_bwd = {BWD_TF32.source: PARITY_MICROBATCHES * calls, BWD_SM90.source: 0}
    if train_counts != want or bwd_counts != want_bwd:
        raise AssertionError(f"fp32 train step launches {train_counts} {bwd_counts}, "
                             f"expected {want} and {want_bwd}")
    if moe and not min(gaps) > ROUTER_GAP:  # a near-tie may route either way
        raise AssertionError(f"fp32 MoE path: a router's top-k gap {min(gaps)} is a near-tie")
    (l_cpu, n_cpu, g_cpu, p_cpu), (l_gpu, n_gpu, g_gpu, p_gpu) = stepped["cpu"], stepped["card"]
    step_err = {"loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
                "grad_norm_rel": abs(n_gpu - n_cpu) / abs(n_cpu),
                "grad_max_rel": max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                                    for a, b in zip(g_gpu, g_cpu)),
                "param_max_abs": max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))}
    grads_ok = all(float((a - b).abs().max()) <= TOL_FP32 * float(b.abs().max()) + 1e-7
                   for a, b in zip(g_gpu, g_cpu))
    # the parameters: every element to 1e-4 of the CPU optimizer's step from
    # the card's gradients (`p_want`), which hold to 1e-4 of the CPU's. Held
    # to the CPU's own step instead, AdamW's m / (sqrt(v) + eps) amplifies
    # the gradients' rounding where |g| nears eps: reduced xlstm-1.3b's
    # gradients agree to 2.3e-6 of each leaf's max, yet one parameter held
    # strictly moved 1.24e-4 from the CPU's, and 0.196% of its elements lie
    # under 1e-4 of their leaf's max (the exemption that rule needed, capped
    # at 0.1%): both are reported, as `param_max_abs` and
    # `under_tolerance_fraction`
    params_ok = all(bool(((a - b).abs() <= TOL_FP32 + TOL_FP32 * b.abs()).all())
                    for a, b in zip(p_gpu, p_want))
    step_err["param_max_abs_vs_card_grads"] = max(float((a - b).abs().max())
                                                  for a, b in zip(p_gpu, p_want))
    step_err["under_tolerance_fraction"] = sum(
        int(((g != 0) & (g.abs() <= TOL_FP32 * g.abs().max())).sum()) for g in g_cpu) / sum(
        x.numel() for x in p_cpu)
    if not (step_err["loss_rel"] <= TOL_FP32 and step_err["grad_norm_rel"] <= TOL_FP32
            and grads_ok and params_ok):
        raise AssertionError(f"fp32 train step: card vs CPU differ: {step_err}")
    return {"launches": counts, "max_abs_err": err, "tol": TOL_FP32,
            "train_step_launches": train_counts, "train_step_backward_launches": bwd_counts,
            "train_step_err": step_err,
            "routes_equal": moe or None, "router_gap_min": min(gaps) if gaps else None,
            "dropped_assignments": [int((~r["kept"]).sum()) for r in routes.get("cpu", [])]}


def moe_layer_phase(cfg, device):
    """One MoE layer of `cfg` at full width, bf16, on the train phase's
    micro-batch (1 x TRAIN_SEQ positions), run twice on the same input: the
    outputs and routes equal bit for bit (remat recomputes each layer in the
    backward, and a token routed otherwise there would leave its gradients
    wrong without an error); and its time a call (CUDA events) beside its
    expert products' time at the card's bf16 rate."""
    from repro_torch.models.moe import _capacity, init_moe, moe_ffn

    g = torch.Generator(device=device)
    g.manual_seed(5)
    p = init_moe(g, cfg, dtype=torch.bfloat16, device=device)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=g, device=device).to(torch.bfloat16)
    a, b = {}, {}
    with torch.inference_mode():
        for run in (a, b):
            with recording_routes(run, "r"):
                run["out"] = moe_ffn(cfg, p, x)
        ms = cuda_ms(lambda: moe_ffn(cfg, p, x), iters=10)
    equal = torch.equal(a["out"], b["out"]) and all(
        torch.equal(ra[k], rb[k]) for ra, rb in zip(a["r"], b["r"]) for k in ("experts", "kept"))
    if not equal:
        raise AssertionError(f"{cfg.arch_id}: a second run of an MoE layer differs")
    C = _capacity(cfg, TRAIN_SEQ)
    flops = 3 * 2.0 * cfg.n_experts * C * cfg.d_model * cfg.moe_d_ff
    res = {"arch": cfg.arch_id, "tokens": TRAIN_SEQ, "capacity": C, "bit_equal": equal,
           "dropped_assignments": int((~a["r"][0]["kept"]).sum()), "event_ms": ms,
           "expert_products_bound_ms": flops / PEAK_BF16_FLOPS * 1e3}
    log("moe layer", json.dumps(res))
    return res


def packed_md(cfg, B, S, device):
    """Packed metadata of B x S `SyntheticPackedDataset` documents (seed 0)."""
    from repro_torch.data.synth import SyntheticPackedDataset

    raw = SyntheticPackedDataset(cfg, S, B, seed=0).batch_at(0)
    seg, pos = (torch.from_numpy(raw[k]).to(device) for k in ("segment_ids", "positions"))
    return {"segment_ids": seg, "positions": pos, "causal": True,
            "abs_positions": torch.arange(S, dtype=torch.int32, device=device).repeat(B, 1)}


def leaf_names(tree, prefix=""):
    """Dotted key paths of a tree of dicts' leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [name for k, v in tree.items() for name in leaf_names(v, f"{prefix}{k}.")]
    return [prefix[:-1]]


def mamba_layer_phase(cfg, device):
    """jamba's period position 1 (Mamba + dense FFN, 1.02 B) at full width
    on the train phase's micro-batch (1 x TRAIN_SEQ packed documents): fp32
    masters, bf16 compute, the layer's forward and the backward of
    sum(out * r) (the gradient of every parameter and of the input), timed
    by CUDA events and run twice, outputs and gradients equal bit for bit
    (remat recomputes a layer in the backward); every gradient held to the
    same layer computed in fp32 on the card, to TOL_MAMBA_GRAD of its
    leaf's max |ref|. This is Mamba's backward at full width, which jamba's
    cut cannot train."""
    from repro_torch.models.model import apply_layer, init_layer
    from repro_torch.train.optimizer import tree_leaves

    spec = cfg.period[1]
    if (spec.mixer, spec.ffn) != ("mamba", "dense"):
        raise AssertionError(f"{cfg.arch_id} period position 1 is {spec}, not Mamba + dense")
    g = torch.Generator(device=device)
    g.manual_seed(6)
    p = init_layer(g, cfg, spec, dtype=torch.float32, device=device)
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    md = packed_md(cfg, 1, TRAIN_SEQ, device)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=g, device=device)
    r = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=g, device=device)

    def run(dtype):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        xi = x.to(dtype).requires_grad_(True)
        events[0].record()
        out, _ = apply_layer(cfg, spec, p, xi, md)
        events[1].record()
        grads = torch.autograd.grad((out.float() * r).sum(), [xi] + leaves)
        events[2].record()
        torch.cuda.synchronize()
        return (out.detach(), [gr.detach() for gr in grads], events[0].elapsed_time(events[1]),
                events[1].elapsed_time(events[2]))

    run(torch.bfloat16)  # warm-up (cuBLAS handles, the allocator)
    torch.cuda.reset_peak_memory_stats()
    first, second = run(torch.bfloat16), run(torch.bfloat16)
    peak = torch.cuda.max_memory_allocated()
    equal = torch.equal(first[0], second[0]) and all(
        torch.equal(a, b) for a, b in zip(first[1], second[1]))
    if not equal:
        raise AssertionError(f"{cfg.arch_id}: a second run of a Mamba layer differs")
    del second
    ref = run(torch.float32)
    errs = [float((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(first[1], ref[1])]
    names = ["x"] + leaf_names(p)
    prof = device_profile(lambda: run(torch.bfloat16), 1, host_ops=False)
    res = {"arch": cfg.arch_id, "period_position": 1, "spec": f"{spec.mixer}+{spec.ffn}",
           "params": sum(x.numel() for x in leaves), "tokens": TRAIN_SEQ, "bit_equal": equal,
           "forward_event_ms": [first[2], ref[2]], "backward_event_ms": [first[3], ref[3]],
           "grad_rel_err": dict(zip(names, errs)), "grad_tol": TOL_MAMBA_GRAD,
           "output_rel_err": rel_err(first[0], ref[0]), "max_memory_allocated_bytes": peak,
           "profile": prof}
    log("mamba layer", json.dumps(res))
    if not max(errs) <= TOL_MAMBA_GRAD:
        raise AssertionError(f"{cfg.arch_id} Mamba layer: bf16 gradients off the fp32 layer's "
                             f"by {res['grad_rel_err']}")
    return res


def loop_profile(cfg, device, B, S, *, train, scale=LOOP_PROFILE_SCALE):
    """Each recurrent mixer of `cfg` alone at full width, one layer of its
    first spec without MoE (its dense FFN, if any, too) on B x S packed
    documents, bf16 compute: the device time and kernel launches of the
    layer and of its loop alone (`SCANS`: the loop over positions or
    chunks, called on the inputs the layer handed it), forward in inference
    mode, and with `train` also forward + backward (fp32 masters, the
    gradient of the output's sum), and of one decode step of the layer from
    a zero cache. -> {mixer: {"layer_forward", "scan_forward", "decode",
    ("layer_train", "scan_train")}}, each a `device_profile`. The layers run
    on S / `scale` positions and their times and launches are multiplied by
    `scale` ("scaled_by"): a loop runs the same launches at every position
    (every chunk), and a profile's processing grows faster than its
    launches (an sLSTM layer's training trace, 315 k launches, took most of
    199 s)."""
    import importlib

    from repro_torch.models.model import _layer_cache, apply_layer, init_layer
    from repro_torch.train.optimizer import tree_leaves

    S //= scale
    md = packed_md(cfg, B, S, device)
    step_md = {"segment_ids": torch.ones((B, 1), dtype=torch.int32, device=device),
               "lengths": torch.zeros((B,), dtype=torch.int32, device=device),
               "positions": torch.zeros((B, 1), dtype=torch.int32, device=device),
               "causal": True}
    g = torch.Generator(device=device)
    g.manual_seed(3)

    def scaled(prof):
        for key in ("device_seconds_per_call", "kernels_per_call"):
            prof[key] *= scale
        return {**prof, "scaled_by": scale}
    res = {}
    for kind in [m for m in RECURRENT if any(sp.mixer == m for sp in cfg.period)]:
        spec = next(sp for sp in sorted(cfg.period, key=lambda sp: sp.ffn == "moe")
                    if sp.mixer == kind)
        module, name = SCANS[kind]
        mod = importlib.import_module(module)
        scan, captured = getattr(mod, name), []

        def capture(*args):
            captured.append(args)
            return scan(*args)

        def layer_profiles(p, x, grad):
            captured.clear()
            setattr(mod, name, capture)
            try:
                apply_layer(cfg, spec, p, x, md)  # warm-up; hands the loop its inputs
            finally:
                setattr(mod, name, scan)
            args = captured[0]
            if not grad:
                return (scaled(device_profile(lambda: apply_layer(cfg, spec, p, x, md), 1,
                                              host_ops=False)),
                        scaled(device_profile(lambda: scan(*args), 1, host_ops=False)))
            args = tuple(a.detach().requires_grad_(True) if isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a for a in args)

            def layer():
                out, _ = apply_layer(cfg, spec, p, x, md)
                torch.autograd.grad(out.float().sum(), tree_leaves(p))

            def loop():
                out = scan(*args)[0]
                torch.autograd.grad(out.float().sum(), [a for a in args if isinstance(
                    a, torch.Tensor) and a.requires_grad])
            layer()  # warm-up: the backward's first launches
            loop()
            return (scaled(device_profile(layer, 1, host_ops=False)),
                    scaled(device_profile(loop, 1, host_ops=False)))

        x = torch.randn((B, S, cfg.d_model), generator=g, device=device).to(torch.bfloat16)
        row = {"spec": f"{spec.mixer}+{spec.ffn}"}
        with torch.inference_mode():
            p = init_layer(g, cfg, spec, dtype=torch.bfloat16, device=device)
            row["layer_forward"], row["scan_forward"] = layer_profiles(p, x, False)
            cache = _layer_cache(cfg, spec, B, 1, torch.bfloat16, device, 0)
            step = lambda: apply_layer(cfg, spec, p, x[:, :1], step_md, cache=cache)  # noqa: E731
            step()
            row["decode"] = device_profile(step, 4, host_ops=False)
        del p, cache
        if train:
            p = init_layer(g, cfg, spec, dtype=torch.float32, device=device)
            for leaf in tree_leaves(p):
                leaf.requires_grad_(True)
            row["layer_train"], row["scan_train"] = layer_profiles(p, x, True)
            del p
        res[kind] = row
        torch.cuda.empty_cache()
    log(f"{cfg.arch_id} loops", json.dumps(res))
    return res


def composed_profile(cfg, loops, keys, wall_seconds):
    """A path's device time and launches composed from its layers'
    profiles (`loop_profile`): each layer's profiles under `keys` summed
    over the model's layers of its mixer (the embedding, the LM head, the
    loss and an optimizer step left out), and the busy share over
    `wall_seconds`, the path's host time."""
    layers = {m: sum(sp.mixer == m for sp in cfg.layer_specs()) for m in loops}
    res = {key: sum(layers[m] * loops[m][k][key] for m in loops for k in keys)
           for key in ("device_seconds_per_call", "kernels_per_call")}
    return {**res, "composed_from": [f"loop_profile {k}" for k in keys],
            "busy_share": res["device_seconds_per_call"] / wall_seconds}


def loop_shares(cfg, loops, path_profile, *, passes):
    """The share of a path's device time in its recurrent loops and its
    launches per layer: `loops` from `loop_profile`, the path's
    `device_profile`, `passes` {profile key of `loop_profile`: times a
    layer runs it in one call of the path}, e.g. a train step's
    {"scan_forward": micro-batches (remat's recompute), "scan_train":
    micro-batches}."""
    layers = {m: sum(sp.mixer == m for sp in cfg.layer_specs()) for m in loops}
    scan_s = sum(layers[m] * k * loops[m][key]["device_seconds_per_call"]
                 for m in loops for key, k in passes.items())
    return {"layers_by_mixer": layers,
            "scan_device_seconds": scan_s,
            "scan_share_of_device_time": scan_s / path_profile["device_seconds_per_call"],
            "kernels_per_call": path_profile["kernels_per_call"],
            "kernels_per_layer": {m: {k: v["kernels_per_call"] for k, v in loops[m].items()
                                      if isinstance(v, dict)} for m in loops}}


def to_tree(tree, device):
    if isinstance(tree, dict):
        return {k: to_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_tree(v, device) for v in tree]
    return tree.to(device)


def to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def forward_phase(cfg, params, device):
    from repro_torch.core.detector.predictor import MicroBatchTimePredictor
    from repro_torch.data.packing import pack_stats
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.kernels.packed_flash_attn import SM90
    from repro_torch.models.model import loss_fn

    ds = SyntheticPackedDataset(cfg, seq_len=4096, global_batch=2, seed=0)
    obs = []
    with torch.inference_mode():
        loss_fn(cfg, params, to_device(ds.batch_at(FORWARD_BATCHES), device))  # warm-up
        for i in range(FORWARD_BATCHES):
            raw = ds.batch_at(i)
            batch = to_device(raw, device)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total, metrics = loss_fn(cfg, params, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts()
            launches = counts[SM90.source]
            if launches != cfg.n_layers or sum(counts.values()) != launches:
                raise AssertionError(f"batch {i}: kernel launches {counts}, expected "
                                     f"{cfg.n_layers} of {SM90.source} only")
            if not (math.isfinite(loss) and math.isfinite(float(total))):
                raise AssertionError(f"batch {i}: loss {loss} is not finite")
            stats = pack_stats(raw["segment_ids"])
            n_tok, l2 = sum(s[0] for s in stats), sum(s[1] for s in stats)
            obs.append((n_tok, l2, dt))
            log(f"forward batch {i}: loss={loss:.6f} seconds={dt:.6f} N={n_tok} sum_l2={l2} "
                f"launches={launches}")
    # whole-model chunk times, as every caller of the reference predictor fits
    # them (n_layers=1)
    pred = MicroBatchTimePredictor()
    for n_tok, l2, dt in obs[:FIT_BATCHES]:
        pred.observe(n_tok, l2, dt)
    pred.fit()
    mape = pred.mape([(n_tok, l2, 1, dt) for n_tok, l2, dt in obs[FIT_BATCHES:]])
    fit = {"alpha": pred.alpha, "beta": pred.beta, "gamma": pred.gamma,
           "mape_heldout": mape, "fit_batches": FIT_BATCHES,
           "heldout_batches": len(obs) - FIT_BATCHES}
    log("eq1 fit", json.dumps(fit))
    return {"batches": [{"N": a, "sum_l2": b, "seconds": c} for a, b, c in obs], "eq1": fit}


# kernel names by what they compute, for the shares of a device profile;
# "dispatch": top-k, sorts, scans, gathers and scatters (the MoE dispatch and
# combine, and the embedding lookup); "other": the rest, elementwise ops and
# copies
KERNEL_GROUPS = {"attention_forward": ("packed_flash_attn",), "attention_backward": ("bwd_",),
                 "gemm": ("gemm", "nvjet"),
                 "dispatch": ("topk", "Topk", "TopK", "adix", "sort", "Sort", "scan", "Scan",
                              "index", "scatter", "gather")}
# operators whose device time a profile also reports: aten::bmm is the MoE
# experts' batched products in a train step (the dense model's products are
# aten::mm; decode attention's einsums are bmm too)
PROFILED_OPS = ("aten::bmm",)


def device_profile(fn, steps, *, host_ops=True):
    """Device time by kernel over `steps` calls of fn, from torch.profiler,
    and the wall time of the same calls (the profiler's host cost included).
    Without `host_ops` the profiler traces the device alone (no operator
    shares): a step of ~15 k small launches took 24 times its own wall time
    with host operators traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    total_us = max(sum(e.self_device_time_total for e in kernels), 1e-6)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    groups = {g: sum(e.self_device_time_total for e in kernels
                     if any(w in e.key for w in words)) / total_us
              for g, words in KERNEL_GROUPS.items()}
    groups["other"] = 1.0 - sum(groups.values())
    return {"device_seconds_per_call": total_us / 1e6 / steps,
            "profiled_wall_seconds_per_call": wall / steps,
            "kernels_per_call": sum(e.count for e in kernels) / steps,
            "top_kernels": [{"name": e.key[:90], "share": e.self_device_time_total / total_us,
                             "count_per_call": e.count / steps} for e in top],
            "group_shares": groups,
            "op_shares": {op: sum(e.device_time_total for e in events
                                  if e.key == op and e.device_type != DeviceType.CUDA) / total_us
                          for op in PROFILED_OPS}}


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def decode_bound(cfg, params, cache):
    """Least ms of a decode step: the bytes it must move (every weight of
    the decoder read once, of the embedding only the batch's rows unless
    the LM head reads it too; every attention cache slot's K, V and
    position read once, which the dense decode attention reads, an
    encoder-decoder's constant cross K/V too; every recurrent state
    (Mamba's conv window and state, an mLSTM's C, n, m, an sLSTM's c, n, m,
    h) read and written once, as the step replaces it) over the card's
    memory rate. With MoE every expert counts: the reference's dispatch
    runs all E experts' products at C = B. An encoder's weights do not
    count: a decode step never runs the encoder."""
    from repro_torch.train.optimizer import tree_leaves

    embed = params["embed"]
    decoder = {k: v for k, v in params.items() if k not in ("enc_layers", "enc_norm")}
    weights = nbytes(*tree_leaves(decoder)) - nbytes(embed)
    weights += nbytes(embed) if cfg.tie_embeddings else SERVE_B * embed[0].numel() * embed.element_size()
    states = nbytes(*(x for c in cache if "k" not in c["mixer"] for x in c["mixer"].values()))
    caches = nbytes(*tree_leaves(cache)) - states
    return {"bound_ms": (weights + caches + 2 * states) / PEAK_BYTES * 1e3,
            "weight_bytes": weights, "cache_bytes": caches, "state_bytes": states}


def moe_decode_check(cfg, params, batch, device):
    """The first decode step of an MoE model held to the packed forward, like
    with like. A prefill (T = 4 x 2048, C = 640 for qwen3-moe) and a packed
    forward over the prompt and the fed token (4 x 2049) rank a row's tokens
    after the earlier rows', so their drops differ, and a decode step
    (T = 4, C = 4) drops nothing: so this check runs both passes with the
    capacity factor at E / k (C = T: nothing dropped, asserted), fills a
    cache by that prefill, decodes one step, and holds its logits to the
    forward's, whose fed token takes the decode step's experts
    (`forcing_last_routes`): a near-tie that bf16 rounds the other way would
    swap an expert. The fed token's route agreement (each layer's experts,
    decode step against the forward's own choice) must reach
    MOE_ROUTE_AGREEMENT_FLOOR; the largest probability mass a swap cost (the
    forward's top-k mass less that of the decode step's experts, over the
    top-k mass) and the argmax agreement are reported. -> (record, the
    decode step's logits)."""
    from repro_torch.models.model import extend_cache, forward_train
    from repro_torch.train.train_step import build_prefill_step, build_serve_step

    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    routes = {}
    with recording_routes(routes, "prefill"):
        last, caches = build_prefill_step(nodrop)(params, batch)
    cache = extend_cache(nodrop, caches, PROMPT + 1)
    del caches
    tok = last[:, -1].argmax(-1).to(torch.int32)
    lengths = torch.full((SERVE_B,), PROMPT, dtype=torch.int32, device=device)
    with recording_routes(routes, "decode"):
        first = build_serve_step(nodrop)(params, cache, {"tokens": tok[:, None],
                                                         "lengths": lengths})[1][:, 0]
    del cache
    ext = {k: torch.cat([v, tok[:, None] if k == "tokens" else
                         (v[:, -1:] + 1 if k == "positions" else v[:, -1:])], 1)
           for k, v in batch.items()}
    with recording_routes(routes, "forward"), forcing_last_routes(routes["decode"],
                                                                  PROMPT + 1) as natural:
        ref = forward_train(nodrop, params, ext)[0][:, PROMPT]
    dropped = sum(int((~r["kept"]).sum()) for key in ("prefill", "forward") for r in routes[key])
    if dropped:
        raise AssertionError(f"{dropped} assignments dropped at capacity factor "
                             f"{nodrop.capacity_factor}")

    def multi_hot(experts):
        return torch.zeros(experts.shape[0], cfg.n_experts, device=experts.device).scatter_(
            1, experts, 1.0)

    shared = [float((multi_hot(d["experts"][:, 0]) * multi_hot(f["experts"])).sum()
                    / d["experts"][:, 0].numel()) for d, f in zip(routes["decode"], natural)]
    agreement = sum(shared) / len(shared)
    if not agreement >= MOE_ROUTE_AGREEMENT_FLOOR:
        raise AssertionError(f"the decode step's experts agree with the forward's on {agreement} "
                             f"of the fed token's assignments, under {MOE_ROUTE_AGREEMENT_FLOOR}")
    return {"capacity_factor": nodrop.capacity_factor, "decode_rel_err": rel_err(first, ref),
            "argmax_agreement": float((first.argmax(-1) == ref.argmax(-1)).float().mean()),
            "route_agreement": agreement, "route_agreement_floor": MOE_ROUTE_AGREEMENT_FLOOR,
            "route_agreement_by_layer": shared,
            "swap_mass_gap_max": max(float(f["mass_gap"].max()) for f in natural)}, first


def dropped_rows(routes):
    """(B,) True where a row had an assignment dropped at any layer of the
    recorded `routes` (`moe_ffn.routes` entries)."""
    return torch.stack([(~r["kept"]).flatten(1).any(1) for r in routes]).any(0)


def main_first_check(first, nodrop_first, prefill_routes):
    """The main path's first decode logits `first` (after a prefill at the
    config's capacity factor, whose routes are `prefill_routes`) against the
    drop-free decode step's `nodrop_first` (`moe_decode_check`), on the rows
    that neither pass dropped an assignment of (a decode step drops nothing:
    C = T): within TOL_DECODE_REL of the held rows' max |logit|, and the same
    argmax on each held row whose top-2 margin exceeds twice that. At 48
    random-weight layers every row may drop; then the main path is held only
    to finite logits and the drop-free check stands for the step's math."""
    held = ~dropped_rows(prefill_routes)
    res = {"main_first_rows_held": int(held.sum()), "main_first_rel_err": None,
           "main_first_argmax_agreement": None, "main_first_held": True}
    if bool(held.any()):
        a, b = first[held].float(), nodrop_first[held].float()
        err = rel_err(a, b)
        top2 = b.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * TOL_DECODE_REL * float(b.abs().max())
        same = a.argmax(-1) == b.argmax(-1)
        res.update(main_first_rel_err=err,
                   main_first_argmax_agreement=float(same.float().mean()),
                   main_first_held=err <= TOL_DECODE_REL and bool(same[clear].all()))
    return res


@contextlib.contextmanager
def forcing_last_routes(decode_routes, S):
    """`moe.route` for a packed forward over rows of S positions whose last
    position is the decode step's token: that token takes, at each MoE
    layer, the experts the decode step chose (`decode_routes`), its gates
    its own probabilities of them renormalised, as `route` forms them. The
    yielded list collects, per layer, the experts it would have taken and
    the share of their probability mass that the forced ones lack."""
    import repro_torch.models.moe as moe_mod

    route, natural = moe_mod.route, []

    def forced(cfg, router, xt):
        gates, experts = route(cfg, router, xt)
        last = torch.arange(S - 1, xt.shape[0], S, device=xt.device)
        want = decode_routes[len(natural)]["experts"][:, 0]
        probs = torch.softmax(xt[last].float() @ router.float(), dim=-1)
        own = probs.gather(1, experts[last]).sum(-1)
        natural.append({"experts": experts[last].clone(),
                        "mass_gap": (own - probs.gather(1, want).sum(-1)) / own})
        probs = probs.gather(1, want)
        gates, experts = gates.clone(), experts.clone()
        gates[last] = probs / probs.sum(-1, keepdim=True).clamp_min(1e-9)
        experts[last] = want
        return gates, experts

    moe_mod.route = forced
    try:
        yield natural
    finally:
        moe_mod.route = route


@contextlib.contextmanager
def recording_gaps(into):
    """`moe.route` recording into the list `into` the least gap between a
    token's k-th and (k+1)-th router probability of each call."""
    import repro_torch.models.moe as moe_mod

    route = moe_mod.route

    def recorded(cfg, router, xt):
        probs = torch.softmax(xt.detach().float() @ router.detach().float(), dim=-1)
        top = probs.topk(cfg.moe_top_k + 1, dim=-1).values
        into.append(float((top[:, -2] - top[:, -1]).min()))
        return route(cfg, router, xt)

    moe_mod.route = recorded
    try:
        yield
    finally:
        moe_mod.route = route


@contextlib.contextmanager
def recording_routes(into, key):
    """`moe_ffn.routes` recording into `into[key]` inside the block."""
    from repro_torch.models.moe import moe_ffn

    into[key] = moe_ffn.routes = []
    try:
        yield
    finally:
        moe_ffn.routes = None


def serve_prompt(cfg, device):
    """SERVE_B prompts of one document a row, random tokens from a seed, and
    the decode step's inputs besides tokens and lengths: (batch, extra).
    An LM's are PROMPT tokens; a VLM's open with a PROMPT / 4 vision span
    (seeded normal embeddings) on a VLM_SERVE_GRID grid; an
    encoder-decoder's are WHISPER_PROMPT decoder tokens over one clip of
    WHISPER_FRAMES frames a row, whose ids the decode step reads."""
    from repro_torch.data.multimodal import mrope_positions

    rng = np.random.default_rng(7)
    P = WHISPER_PROMPT if cfg.enc_dec else PROMPT

    def ids(S):
        return (torch.ones((SERVE_B, S), dtype=torch.int32, device=device),
                torch.arange(S, dtype=torch.int32, device=device).repeat(SERVE_B, 1))
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(SERVE_B, P)).astype(np.int32))
    seg, pos = ids(P)
    if cfg.enc_dec:
        enc_seg, enc_pos = ids(WHISPER_FRAMES)
        frames = rng.standard_normal((SERVE_B, WHISPER_FRAMES, cfg.d_model), dtype=np.float32)
        batch = {"frame_embeds": torch.from_numpy(frames).to(device),
                 "enc_segment_ids": enc_seg, "enc_positions": enc_pos,
                 "dec_tokens": tokens.to(device), "dec_segment_ids": seg, "dec_positions": pos}
        return batch, {"cross_segment_ids": enc_seg, "cross_positions": enc_pos}
    batch = {"tokens": tokens.to(device), "segment_ids": seg, "positions": pos}
    if cfg.vlm:
        vis = P // 4
        batch["positions"] = torch.from_numpy(
            mrope_positions(np.arange(P, dtype=np.int32), vis, VLM_SERVE_GRID)).to(device)[
                None].repeat(SERVE_B, 1, 1)
        batch["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((SERVE_B, vis, cfg.d_model), dtype=np.float32)).to(device)
    return batch, {}


def appended(cfg, batch, fed):
    """The prompt `batch` with the (B, n) tokens `fed` appended to its one
    document a row, as decode feeds them: token i at position P + i (on all
    three M-RoPE axes), the vision span and the encoder frames as they were."""
    pre = "dec_" if cfg.enc_dec else ""
    tokens = batch[pre + "tokens"]
    B, P = tokens.shape
    n = fed.shape[1]
    pos = torch.arange(P, P + n, dtype=torch.int32, device=tokens.device).repeat(B, 1)
    if cfg.mrope_sections is not None:
        pos = pos[..., None].expand(B, n, 3)
    out = dict(batch)
    out[pre + "tokens"] = torch.cat([tokens, fed.to(tokens.dtype)], 1)
    out[pre + "segment_ids"] = torch.cat([batch[pre + "segment_ids"],
                                          batch[pre + "segment_ids"][:, -1:].expand(B, n)], 1)
    out[pre + "positions"] = torch.cat([batch[pre + "positions"], pos], 1)
    return out


def serve_phase(cfg, params, device, *, new_tokens=NEW_TOKENS, check_last=False, max_len=None,
                profile_prefill=True, keep=None):
    """The main path: prefill through the kernel, then greedy decode (over
    ring caches for sliding-window layers; an encoder-decoder's decoder
    over the prefill's constant cross caches) of the `serve_prompt`
    prompts, into caches of `max_len` slots (the prompt and the new tokens
    by default). The first decode step is held to the packed forward (with
    MoE, by `moe_decode_check`, and the main path's on the rows its prefill
    dropped nothing of to that check's decode step, which drops nothing:
    like with like); with `check_last`, the last step too, to a
    teacher-forced packed forward over the prompt and the fed tokens. A
    model with mLSTM layers holds its first decode step to the port's own
    decode step in fp32, from an fp32 copy of the weights and the prefill's
    state: the reference's mLSTM decode drops the causal conv's window
    (src/repro/models/xlstm.py:79-81), so its decode leaves its packed
    forward. No plain attention call on the path. A model with recurrent
    layers is profiled on the device alone; without `profile_prefill` its
    prefill is not profiled (the caller composes its device time: a
    profile's processing of xlstm-1.3b's 320 k launches took about a
    minute). A `keep` dict gets what the sharded serving of the sharding
    phase is held to: the tokens, the prefill's last logits and the first
    SHARD_NEW_TOKENS decode steps' logits (float32, on the host) and the
    cache's slots."""
    from repro_torch.kernels.packed_flash_attn import kernel_for
    from repro_torch.models.model import cache_len, extend_cache, forward_train, serve_forward
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.train_step import build_prefill_step, build_serve_step

    batch, extra = serve_prompt(cfg, device)
    P = row_ids(cfg, batch).shape[1]
    prefill_step, serve_step = build_prefill_step(cfg), build_serve_step(cfg)
    max_len = max_len or P + new_tokens
    calls = attention_calls(cfg)
    kern = kernel_for(torch.bfloat16, cfg.head_dim) if calls else None
    moe = bool(cfg.n_experts)
    own_decode = any(spec.mixer == "mlstm" for spec in cfg.layer_specs())
    host_ops = not recurrent(cfg)
    routes = {}
    with torch.inference_mode():
        with recording_routes(routes, "prefill") if moe else contextlib.nullcontext():
            prefill_step(params, batch)  # warm-up (allocator, cuBLAS handles); the routes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        plain, undo_plain = counting_plain_calls()
        regimes, undo_regimes = counting_regimes()
        t0 = time.perf_counter()
        last_logits, caches = prefill_step(params, batch)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        undo_regimes()
        cache = extend_cache(cfg, caches, max_len)
        del caches
        # the state the first decode step reads, in fp32 (decode replaces
        # recurrent states and writes attention slots in place)
        state0 = tree_map(lambda x: x.float().clone(), cache) if own_decode else None
        tok = last_logits[:, -1].argmax(-1).to(torch.int32)
        first_tok, generated, first_logits, kept = tok, [tok], None, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(new_tokens):
            lengths = torch.full((SERVE_B,), P + i, dtype=torch.int32, device=device)
            tok, logits, cache = serve_step(params, cache, {"tokens": tok[:, None],
                                                            "lengths": lengths, **extra})
            if first_logits is None:
                first_logits = logits[:, 0].clone()
            if keep is not None and i < SHARD_NEW_TOKENS:
                kept.append(logits[:, 0])
            generated.append(tok)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        undo_plain()
        last_logits_decode = logits[:, 0].clone()
        by_source = read_counts()
        launches = sum(by_source.values())
        peak = torch.cuda.max_memory_allocated()
        if (kern is not None and by_source[kern.source] != calls) or launches != calls or plain[
                "plain_calls"]:
            raise AssertionError(f"main path launches {by_source} and {plain}, expected "
                                 f"{calls} of {kern.source if kern else 'no source'} only")
        out = torch.stack(generated, 1)
        if keep is not None:
            keep.update(tokens=out.cpu(), prefill=last_logits[:, 0].float().cpu(),
                        decode=[x.float().cpu() for x in kept], max_len=max_len)
        del kept
        if out.shape != (SERVE_B, new_tokens + 1) or not all(
                bool(torch.isfinite(x.float()).all()) for x in (first_logits, logits)):
            raise AssertionError("decode output has the wrong shape or non-finite logits")
        slots = sorted({cache_len(cfg, spec, max_len) for spec in cfg.layer_specs()
                        if spec.mixer == "attn"})
        ring_pos = [c["mixer"]["pos"] for c in cache
                    if "pos" in c["mixer"] and c["mixer"]["pos"].shape[1] < max_len]
        # a ring of T slots must hold exactly the last T positions written
        ring_wrapped = bool(ring_pos) and all(int(p.min()) == P + new_tokens - p.shape[1]
                                              for p in ring_pos)

        full, _ = forward_train(cfg, params, batch)
        e_prefill = rel_err(last_logits[:, 0], full[:, -1])
        del full
        step_batch = {"tokens": first_tok[:, None],
                      "lengths": torch.full((SERVE_B,), P, dtype=torch.int32, device=device),
                      **extra}
        moe_res = None
        if moe:  # the main path's drops; the decode check without them
            check, nodrop_first = moe_decode_check(cfg, params, batch, device)
            moe_res = {"prefill_dropped_by_layer": [int((~r["kept"]).sum())
                                                    for r in routes["prefill"]],
                       "prefill_assignments_per_layer": routes["prefill"][0]["kept"].numel(),
                       **check, **main_first_check(first_logits, nodrop_first,
                                                   routes["prefill"])}
            e_decode, agree = moe_res["decode_rel_err"], moe_res["argmax_agreement"]
            first_ref = "drop-free packed forward"
        elif own_decode:  # the port's decode step in fp32 from the same state
            p32 = tree_map(lambda x: x.float(), params)
            ref_first = serve_forward(cfg, p32, state0, step_batch,
                                      compute_dtype=torch.float32)[0][:, 0]
            del p32, state0
            e_decode = rel_err(first_logits, ref_first)
            agree = float((first_logits.argmax(-1) == ref_first.argmax(-1)).float().mean())
            first_ref = "fp32 decode step"
        else:
            full, _ = forward_train(cfg, params, appended(cfg, batch, first_tok[:, None]))
            ref_first = full[:, P]
            e_decode = rel_err(first_logits, ref_first)
            agree = float((first_logits.argmax(-1) == ref_first.argmax(-1)).float().mean())
            del full
            first_ref = "packed forward"
        e_last = None
        if check_last:  # every fed token, teacher-forced through the packed forward
            fed = torch.stack(generated[:new_tokens], 1)
            full, _ = forward_train(cfg, params, appended(cfg, batch, fed))
            e_last = rel_err(last_logits_decode, full[:, -1])
            del full
        # where the time goes: device time by kernel; busy share against the
        # unprofiled wall time of the same call
        prof_prefill = (device_profile(lambda: prefill_step(params, batch), steps=1,
                                       host_ops=host_ops) if profile_prefill else None)
        prof_decode = device_profile(lambda: serve_step(params, cache, step_batch), steps=4,
                                     host_ops=host_ops)
        bound = decode_bound(cfg, params, cache)
    if prof_prefill is not None:
        prof_prefill["busy_share"] = prof_prefill["device_seconds_per_call"] / t_prefill
    prof_decode["busy_share"] = prof_decode["device_seconds_per_call"] / (t_decode / new_tokens)
    if e_prefill > TOL_PREFILL_REL:
        raise AssertionError(f"prefill logits off the packed forward by {e_prefill} (rel)")
    if e_decode > TOL_DECODE_REL:
        raise AssertionError(f"first decode logits off the {first_ref} by {e_decode} (rel)"
                             f"{f'; MoE checks {moe_res}' if moe else ''}")
    if moe and not moe_res["main_first_held"]:
        raise AssertionError(f"the main path's first decode step, on the rows its prefill "
                             f"dropped nothing of, off the drop-free one: {moe_res}")
    if e_last is not None and not e_last <= TOL_DECODE_REL:
        raise AssertionError(f"last decode logits off the teacher-forced packed forward by "
                             f"{e_last} (rel)")
    if ring_pos and not ring_wrapped:
        raise AssertionError("the sliding-window ring caches did not hold the last positions")
    res = {"arch": cfg.arch_id, "layers": cfg.n_layers, "params": cfg.param_count(),
           "prompt": P, "encoder_frames": batch["frame_embeds"].shape[1] if cfg.enc_dec else None,
           "vision_embeddings": batch["vision_embeds"].shape[1] if cfg.vlm else None,
           "new_tokens": new_tokens, "cache_slots": slots, "ring_layers": len(ring_pos),
           "attention_layers": calls,
           "mixers": {m: sum(s.mixer == m for s in cfg.layer_specs())
                      for m in ("attn",) + RECURRENT},
           "ring_wrapped": ring_wrapped,
           "prefill_seconds": t_prefill, "decode_ms_per_token": t_decode / new_tokens * 1e3,
           "decode_tokens_per_s": SERVE_B * new_tokens / t_decode,
           "prefill_tokens_per_s": SERVE_B * P / t_prefill,
           "max_memory_allocated_bytes": peak, "main_path_launches": launches,
           "main_path_launches_by_source": by_source, "prefill_calls_by_regime": regimes,
           "prefill_rel_err": e_prefill, "prefill_tol": TOL_PREFILL_REL,
           "decode_rel_err": e_decode, "decode_tol": TOL_DECODE_REL,
           "first_decode_reference": first_ref,
           "last_decode_rel_err": e_last,
           "first_decode_argmax_agreement": agree, "decode_bound": bound,
           "decode_bound_share": bound["bound_ms"] / (t_decode / new_tokens * 1e3),
           "plain_calls": plain["plain_calls"], "moe": moe_res,
           "prefill_profile": prof_prefill, "decode_profile": prof_decode}
    log("serve", json.dumps(res))
    return res


def bf16_launches(head_dim, *, forward, backward):
    """Expected launch counts of a bf16 run at `head_dim`: `forward` of the
    tensor-core forward and `backward` of the tensor-core backward, none of
    the fp32 sources (at every head width, 256 included), no
    plain-version call (a model without attention: none of any)."""
    from repro_torch.kernels.packed_flash_attn import (
        BWD_SM90, BWD_TF32, FWD_TF32, SM90, backward_kernel_for, kernel_for)

    if (forward or backward) and (kernel_for(torch.bfloat16, head_dim).source != SM90.source
            or backward_kernel_for(torch.bfloat16, head_dim).source != BWD_SM90.source):
        raise AssertionError(f"bf16 at head_dim {head_dim} does not take the tensor-core kernels")
    return {SM90.source: forward, FWD_TF32.source: 0, f"backward[{BWD_SM90.source}]": backward,
            f"backward[{BWD_TF32.source}]": 0, "plain_calls": 0}


def counting_plain_calls():
    """Count calls of the plain attention version through `kernels.ops`
    (none may happen on a card's main path). Returns (counts, undo)."""
    from repro_torch.kernels import ops

    plain, calls = ops.packed_attention_ref, {"plain_calls": 0}

    def counted(*a, **kw):
        calls["plain_calls"] += 1
        return plain(*a, **kw)

    ops.packed_attention_ref = counted
    return calls, lambda: setattr(ops, "packed_attention_ref", plain)


def counting_regimes():
    """Count the model's calls of the packed attention through
    `models.attention.packed_attention` by regime: causal self-attention,
    non-causal self-attention (an encoder), cross-attention (query and key
    ids of two sequences). Returns (counts, undo)."""
    import repro_torch.models.attention as attn

    inner, calls = attn.packed_attention, {"causal": 0, "non_causal": 0, "cross": 0}

    def counted(q, k, v, seg_q, seg_k, *a, causal=True, **kw):
        calls["cross" if seg_k is not seg_q else "causal" if causal else "non_causal"] += 1
        return inner(q, k, v, seg_q, seg_k, *a, causal=causal, **kw)

    attn.packed_attention = counted
    return calls, lambda: setattr(attn, "packed_attention", inner)


def train_phase(cfg, device, *, layers=TRAIN_LAYERS, steps=TRAIN_STEPS, fit=TRAIN_FIT,
                batch=TRAIN_BATCH, microbatches=TRAIN_MICROBATCHES, profile=True,
                warmup=TRAIN_WARMUP, accum_check=False):
    """The training path: a model at full width, cut to `layers` layers (None:
    full depth), trained for `steps` steps of `batch` rows of TRAIN_SEQ in
    `microbatches` micro-batches by the port's spmd driver
    (`launch.train.run_spmd`) through the bf16 forward and backward kernels
    of its head width (none for a model without attention). Checks every
    step's launches and step 0's gradients and loss; reports step times
    (the first `warmup` left out of the steady ones), the Eq. 1 fit (on `fit` steps after the warm-up, held out on the rest;
    None: no fit) and the Detector's statistics; with `profile`, the device
    profile of step TRAIN_PROFILED_STEP (on the device alone for a model
    with recurrent layers); with `accum_check`, step 0 again with bf16
    gradient accumulation (`bf16_accumulation_step`)."""
    import repro_torch.launch.train as driver
    from repro_torch.core.detector.predictor import MicroBatchTimePredictor
    from repro_torch.data.packing import pack_stats
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.train.optimizer import tree_leaves

    tcfg = cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)  # depth only
    L, S, B, mb = tcfg.n_layers, TRAIN_SEQ, batch, microbatches
    calls = attention_calls(tcfg)
    args = driver.parser().parse_args(
        ["--steps", str(steps), "--seq-len", str(S), "--batch", str(B), "--microbatches",
         str(mb), "--lr", "1e-3", "--seed", "0", "--device", str(device)])
    ds = SyntheticPackedDataset(tcfg, S, B, seed=args.seed)

    # step 0's loss by loss_fn, on the params the driver draws from the same
    # seed and on the same micro-batches, before the counted run
    params = init_params(tcfg, args.seed, dtype=torch.float32, device=device)
    batch, n = to_device(ds.batch_at(0), device), B // mb
    with torch.no_grad():
        loss0_fn = sum(float(loss_fn(tcfg, params, {k: v[i * n:(i + 1) * n]
                                                    for k, v in batch.items()})[0])
                       for i in range(mb)) / mb
    del params, batch
    torch.cuda.empty_cache()

    def counts():
        return {**read_counts(), **{f"backward[{k}]": v for k, v in read_backward_counts().items()},
                "plain_calls": plain["plain_calls"]}

    per_step, step0 = [], {}
    build = driver.build_train_step

    def checked_build(cfg_, opt, **kw):
        step_fn = build(cfg_, opt, **kw)

        def step(state, batch):
            before = counts()
            if profile and len(per_step) == TRAIN_PROFILED_STEP:
                out = []
                step0["profile"] = device_profile(lambda: out.append(step_fn(state, batch)), 1,
                                                  host_ops=not recurrent(tcfg))
                state, metrics = out[0]
            else:
                state, metrics = step_fn(state, batch)
            per_step.append({k: v - before[k] for k, v in counts().items()})
            if len(per_step) == 1:
                flags = [bool(torch.isfinite(p.grad).all() & (p.grad != 0).any())
                         for p in tree_leaves(state["params"])]
                step0.update(leaves=len(flags), leaves_with_finite_nonzero_grad=sum(flags))
                if accum_check:  # what the bf16 accumulation's step 0 is held to
                    step0["grads"] = [p.grad.to("cpu") for p in tree_leaves(state["params"])]
            return state, metrics

        return step

    plain, undo = counting_plain_calls()
    driver.build_train_step = checked_build
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        result = driver.run_spmd(tcfg, args)
        torch.cuda.synchronize()
        total = counts()
    finally:
        driver.build_train_step = build
        undo()
    peak = torch.cuda.max_memory_allocated()

    # per step: each micro-batch runs every layer's forward kernel twice
    # (forward and remat recompute) and its backward kernel once, all bf16,
    # of the sources for the head width
    want = bf16_launches(tcfg.head_dim, forward=2 * calls * mb, backward=calls * mb)
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"train step {i}: launches {got}, expected {want}")
    if len(per_step) != steps or total != {k: v * steps for k, v in want.items()}:
        raise AssertionError(f"train run: {len(per_step)} steps, launches {total}")
    if step0["leaves_with_finite_nonzero_grad"] != step0["leaves"]:
        raise AssertionError(f"step 0: only {step0['leaves_with_finite_nonzero_grad']} of "
                             f"{step0['leaves']} parameter leaves have a finite nonzero gradient")
    losses, times = result["losses"], result["times"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses not finite: {losses}")
    loss0_rel = abs(losses[0] - loss0_fn) / abs(loss0_fn)
    if not loss0_rel <= 1e-3:
        raise AssertionError(f"step 0 loss {losses[0]} vs loss_fn {loss0_fn}")

    # Eq. 1 on whole-step times (forward + backward of both micro-batches),
    # after the warm-up steps the driver skips too
    obs = []
    for it in range(warmup, steps):
        stats = pack_stats(ds.batch_at(it)["segment_ids"])
        obs.append((sum(x[0] for x in stats), sum(x[1] for x in stats), times[it]))
    eq1 = None
    if fit is not None:
        pred = MicroBatchTimePredictor()
        for n_tok, l2, dt in obs[:fit]:
            pred.observe(n_tok, l2, dt)
        pred.fit()
        eq1 = {"alpha": pred.alpha, "beta": pred.beta, "gamma": pred.gamma,
               "mape_heldout": pred.mape([(n_tok, l2, 1, dt) for n_tok, l2, dt in obs[fit:]]),
               "fit_steps": fit, "heldout_steps": len(obs) - fit}
    steady = times[warmup:]
    res = {"arch": cfg.arch_id, "layers": L, "steps": steps, "seq_len": S, "batch": B,
           "microbatches": mb, "head_dim": tcfg.head_dim, "window": arch_window(tcfg),
           "params": tcfg.param_count(), "losses": losses, "step_seconds": times,
           "step_seconds_mean": sum(steady) / len(steady),
           "step_seconds_min": min(steady), "step_seconds_max": max(steady),
           "positions_per_s": B * S * len(steady) / sum(steady),
           "tokens_per_s": sum(o[0] for o in obs) / sum(steady),
           "launches_per_step": want, "launches": total,
           "step0_loss": losses[0], "step0_loss_fn": loss0_fn, "step0_loss_rel": loss0_rel,
           "step0_leaves": step0["leaves"], "attention_layers": calls, "eq1": eq1,
           "detector": result["detector"], "max_memory_allocated_bytes": peak,
           "profiled_step": TRAIN_PROFILED_STEP if profile else None,
           "profile": step0.get("profile")}
    # device time over the wall time of the same step; the profiler's host
    # cost counts in that wall, so this is a lower bound on the busy share
    prof = res["profile"]
    if prof is not None:
        prof["busy_share"] = (prof["device_seconds_per_call"]
                              / prof["profiled_wall_seconds_per_call"])
    if accum_check:
        torch.cuda.empty_cache()
        res["bf16_accumulation"] = bf16_accumulation_step(
            tcfg, args, ds.batch_at(0), step0.pop("grads"), losses[0], peak, device, want)
    log("train", json.dumps(res))
    return res


def bf16_accumulation_step(cfg, args, batch, fp32_grads, fp32_loss, fp32_peak, device, want):
    """Step 0 of the train phase again (`run_spmd`'s seed, optimizer and
    micro-batches, the same batch) through `build_train_step(...,
    accum_dtype=torch.bfloat16)`, the reference's accumulation above 5e10
    parameters: its loss beside the fp32 step's, every leaf's finite
    nonzero clipped gradient within TOL_BF16 of that leaf's max abs of the
    fp32 step 0's (`fp32_grads`, on the host), its launches (counted from
    0 around the step) those of a train step (`want`), and its peak
    allocated memory beside the fp32 run's."""
    from repro_torch.train.optimizer import optimizer_for, tree_leaves
    from repro_torch.train.train_step import build_train_step, init_train_state

    opt = optimizer_for(cfg, lr=args.lr)
    state = init_train_state(args.seed, cfg, opt, device=device)
    step = build_train_step(cfg, opt, microbatches=args.microbatches, remat=True,
                            accum_dtype=torch.bfloat16)
    batch = to_device(batch, device)
    plain, undo = counting_plain_calls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        seconds = time.perf_counter() - t0
        launches = {**read_counts(), **{f"backward[{k}]": v
                                        for k, v in read_backward_counts().items()},
                    "plain_calls": plain["plain_calls"]}
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    if launches != want:
        raise AssertionError(f"bf16 accumulation step: launches {launches}, expected {want}")
    errs, leaves = [], tree_leaves(state["params"])
    for p, ref in zip(leaves, fp32_grads, strict=True):
        ref = ref.to(device)
        if not bool(torch.isfinite(p.grad).all() & (p.grad != 0).any()):
            raise AssertionError(f"bf16 accumulation: a leaf of shape {tuple(p.shape)} has no "
                                 "finite nonzero gradient")
        errs.append(float((p.grad - ref).abs().max()) / max(float(ref.abs().max()), 1e-30))
    del state, fp32_grads
    if not max(errs) <= TOL_BF16:
        raise AssertionError(f"bf16 accumulation: gradients {max(errs)} of their leaf's max "
                             f"abs from the fp32 step's (tol {TOL_BF16})")
    res = {"accum_dtype": "bfloat16", "loss": loss, "fp32_loss": fp32_loss,
           "loss_rel": abs(loss - fp32_loss) / abs(fp32_loss), "grad_norm": float(
               metrics["grad_norm"]), "leaves": len(leaves), "max_grad_err_of_leaf_max": max(errs),
           "tol": TOL_BF16, "step_seconds": seconds, "launches": launches,
           "max_memory_allocated_bytes": peak, "fp32_run_max_memory_allocated_bytes": fp32_peak}
    log("train bf16 accumulation", json.dumps(res))
    return res


def counting_lse_calls():
    """Count the forward wrapper's calls through `kernels.ops` by whether
    they ask for the row log-sum-exp (the autograd path) or not. Returns
    (counts, undo)."""
    from repro_torch.kernels import ops

    inner, calls = ops.packed_flash_attention, {"with_lse": 0, "without_lse": 0}

    def counted(*a, return_lse=False, **kw):
        calls["with_lse" if return_lse else "without_lse"] += 1
        return inner(*a, return_lse=return_lse, **kw)

    ops.packed_flash_attention = counted
    return calls, lambda: setattr(ops, "packed_flash_attention", inner)


def pipeline_args(driver, steps, seq, batch, device, *extra):
    return driver.parser().parse_args(
        ["--mode", "pipeline", "--steps", str(steps), "--seq-len", str(seq), "--batch", str(batch),
         "--microbatches", str(PIPE_MICROBATCHES), "--lr", "1e-3", "--seed", "0",
         "--device", str(device), *extra])


def pipeline_phase(cfg, device, spec):
    """The ResiHP runtime: the port's pipeline driver
    (`launch.train.run_pipeline`) on `cfg` cut to `spec["layers"]` layers
    (None: full depth) under the spec's dp x pp x tp plan, with its fail-stop
    and fail-slow injections. Checks the reconfiguration steps and plans,
    every step's launches, the engine's loss against `loss_fn` on the same
    parameters and batch before the update at the checked steps, and then,
    with two replicas or more, the migration identity and, where the spec
    names a `migrator`, Algorithm 1's placement (`migrator_check`); reports
    step times around each reconfiguration, the planning and recovery
    overheads, peak memory and, on stage meshes, each step's hand-off bytes
    (`hand_off_bytes`)."""
    import repro_torch.launch.train as driver
    from repro_torch.core.detector.dag_sim import ChunkId
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.models.model import loss_fn

    from repro_torch.core.scheduler.plan import initial_plan

    tcfg = cfg if spec["layers"] is None else dataclasses.replace(cfg, n_layers=spec["layers"])
    plan = spec["plan"]
    steps, profiled, reconfigs = spec["steps"], spec["profiled"], spec["reconfigs"]
    batch_size = plan["dp"] * PIPE_MICROBATCHES  # 1 x 4096 a micro-batch
    flags = [x for k, v in plan.items() for x in (f"--{k}", str(v))]
    for name in ("failstop", "failslow"):
        if spec[name]:
            flags += [f"--inject-{name}", spec[name]]
    args = pipeline_args(driver, steps, PIPE_SEQ, batch_size, device, *flags)
    ds = SyntheticPackedDataset(tcfg, PIPE_SEQ, batch_size, seed=args.seed)

    def counts():
        return {**read_counts(), **{f"backward[{k}]": v for k, v in read_backward_counts().items()},
                "plain_calls": plain["plain_calls"], **{f"forward_{k}": v for k, v in lse.items()}}

    def diff(after, before):
        return {k: v - before[k] for k, v in after.items()}

    per_step, checks, engines, prof, engine_seconds, hand_offs = [], [], [], {}, [], []
    check_launches, adaptations = {}, []
    Engine, Controller = driver.PipelineEngine, driver.ResiHPController

    class KeptController(Controller):
        """`run_pipeline`'s controller, keeping each adaptation with its Scheduler."""

        def adapt(self, now=0.0):
            adaptation = super().adapt(now)
            if adaptation is not None:
                adaptations.append((self.scheduler, adaptation))
            return adaptation

    class CheckedEngine(Engine):
        """The driver's engine, with each step's launches counted and, at the
        checked steps, its loss held to loss_fn before the update."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

        def run_iteration(self, batch, **kw):
            step = self.step
            ref = None
            if step in spec["checked"]:
                before = counts()
                with torch.no_grad():  # token-weighted over rows, as the engine forms it
                    nll = ntok = 0.0
                    for b in range(batch["tokens"].shape[0]):
                        _, m = loss_fn(tcfg, self.params_full, {k: v[b:b + 1]
                                                                for k, v in batch.items()})
                        nll += float(m["loss"]) * float(m["ntokens"])
                        ntok += float(m["ntokens"])
                ref = nll / ntok
                for k, v in diff(counts(), before).items():
                    check_launches[k] = check_launches.get(k, 0) + v
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == profiled:
                out = []
                prof.update(device_profile(
                    lambda: out.append(Engine.run_iteration(self, batch, **kw)[0]), 1))
                loss = out[0]
            else:
                loss = Engine.run_iteration(self, batch, **kw)[0]
            torch.cuda.synchronize()
            engine_seconds.append(time.perf_counter() - t0)
            per_step.append(diff(counts(), before))
            hand_offs.append(hand_off_bytes(self, tcfg))
            if ref is not None:
                checks.append({"step": step, "engine_loss": loss, "loss_fn": ref,
                               "rel": abs(loss - ref) / abs(ref), "plan": self.plan.summary()})
            return loss, None

    plain, undo_plain = counting_plain_calls()
    lse, undo_lse = counting_lse_calls()
    driver.PipelineEngine, driver.ResiHPController = CheckedEngine, KeptController
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        result = driver.run_pipeline(tcfg, args)
        torch.cuda.synchronize()
        total = counts()
    finally:
        driver.PipelineEngine, driver.ResiHPController = Engine, Controller
        undo_plain()
        undo_lse()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()

    # per step, whatever the partition: every micro-batch of every replica
    # runs each layer's forward kernel in F (no row log-sum-exp) and in B's
    # recompute (with it), and each layer's backward kernel once in B
    L, R, M = tcfg.n_layers, plan["dp"], PIPE_MICROBATCHES
    want = {**bf16_launches(tcfg.head_dim, forward=2 * L * R * M, backward=L * R * M),
            "forward_with_lse": L * R * M, "forward_without_lse": L * R * M}
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"pipeline step {i}: launches {got}, expected {want}")
    engine_total = {k: v - check_launches.get(k, 0) for k, v in total.items()}
    if len(per_step) != steps or engine_total != {k: v * steps for k, v in want.items()}:
        raise AssertionError(f"pipeline run: {len(per_step)} steps, launches {engine_total} "
                             f"(besides {check_launches} of the loss_fn checks)")
    # the engine's own step times: the driver's also hold the loss_fn checks
    losses, times = result["losses"], engine_seconds[:]  # before the migration check's runs
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"pipeline losses not finite: {losses}")
    if result["reconfigs"] != reconfigs:
        raise AssertionError(f"reconfigurations at {result['reconfigs']}, expected {reconfigs}")
    initial = initial_plan(L, **plan).summary()
    plans = [initial] + [a["plan"] for a in result["adaptations"]]
    in_effect = [plans[sum(r <= c for r in reconfigs)] for c in spec["checked"]]
    if len(set(plans)) != len(plans) or [c["plan"] for c in checks] != in_effect:
        raise AssertionError(f"the plans did not change as injected: {plans}, checks {checks}")
    if [c["step"] for c in checks] != list(spec["checked"]) or not all(
            c["rel"] <= TOL_PIPE_LOSS_REL for c in checks):
        raise AssertionError(f"engine loss vs loss_fn: {checks}")

    # migration identity: F and B of (mb 0, stage 1, replica 0) on replica 1,
    # optimizer off, on the final plan; the same loss
    engine = engines[0]
    stage_meshes = {f"dp{r},pp{st}": {"ranks": list(engine.ranks[(r, st)]),
                                      "shape": list(engine.meshes[(r, st)].shape),
                                      "tp": engine.policies[(r, st)].tp}
                    for r, st in engine.ranks} if engine.spmd else None
    migration = None
    if R > 1:
        engine.optimizer = None
        batch = to_device(ds.batch_at(steps), device)
        base = engine.run_iteration(batch)[0]
        placement = {ChunkId("F", 0, 1, 0): (1, 1), ChunkId("B", 0, 1, 0): (1, 1)}
        migrated = engine.run_iteration(batch, placement=placement)[0]
        torch.cuda.synchronize()
        if not abs(base - migrated) <= TOL_MIGRATION:
            raise AssertionError(f"migration identity: {base} vs {migrated}")
        migration = {"base": base, "migrated": migrated, "abs": abs(base - migrated),
                     "tol": TOL_MIGRATION}
        if spec.get("migrator"):
            migration["migrator"] = migrator_check(engine, adaptations[-1], batch, base,
                                                   *spec["migrator"], counts, diff)
    del engine, engines[:]

    def steady(lo, hi):  # step 0 warms up; the profiled step carries the profiler's host cost
        xs = [times[i] for i in range(max(lo, 1), hi) if i != profiled]
        return sum(xs) / len(xs)

    bounds = [0, *reconfigs, steps]
    segments = ["before", "after_failstop", "after_failslow"][:len(bounds) - 1]
    res = {"arch": cfg.arch_id, "layers": L, "steps": steps, "seq_len": PIPE_SEQ,
           "batch": batch_size, "microbatches": M, "plan": plan, "failstop": spec["failstop"],
           "failslow": spec["failslow"], "params": tcfg.param_count(), "losses": losses,
           "step_seconds": times, "driver_step_seconds": result["times"],
           "reconfigs": result["reconfigs"], "plans": plans,
           "step_seconds_mean": {name: steady(lo, hi)
                                 for name, lo, hi in zip(segments, bounds, bounds[1:])},
           "first_step_after": dict(zip(segments[1:], (times[r] for r in reconfigs))),
           "adaptations": result["adaptations"],
           "loss_checks": checks, "loss_tol_rel": TOL_PIPE_LOSS_REL, "migration": migration,
           "launches_per_step": want, "launches_by_step": per_step[:steps],
           "launches": engine_total, "check_launches": check_launches,
           "spmd": stage_meshes is not None, "stage_meshes": stage_meshes,
           "hand_off_bytes": hand_offs[:steps] if stage_meshes is not None else None,
           "max_memory_allocated_bytes": peak, "max_memory_reserved_bytes": reserved,
           "profiled_step": profiled, "profile": prof}
    if prof:
        prof["busy_share"] = (prof["device_seconds_per_call"]
                              / prof["profiled_wall_seconds_per_call"])
    for ad in result["adaptations"]:
        log(f"pipeline adaptation at step {ad['step']}: {ad['plan']}; {len(ad['moves'])} layer "
            f"moves, {ad['bytes']} bytes modelled; plan_overhead_s {ad['plan_overhead_s']:.6f}; "
            f"recover + apply_plan {ad['recover_seconds']:.6f} s")
    log(f"pipeline {cfg.arch_id} step seconds: {times}")
    log("pipeline", json.dumps(res))
    return res


def hand_off_bytes(engine, cfg):
    """The engine's last iteration's hand-offs under a process group: the
    bytes this rank sent by point-to-point and Fig. 7's `p2p_cost_bytes`
    of each hand-off (one boundary tensor: a 1 x PIPE_SEQ bf16 micro-batch
    of d_model), summed; None for the unsharded engine."""
    from repro_torch.core.scheduler.p2p import p2p_cost_bytes

    if not engine.spmd:
        return None
    tensor = PIPE_SEQ * cfg.d_model * 2
    return {"hand_offs": len(engine.hand_offs),
            "sent_bytes": sum(sent for _, _, sent in engine.hand_offs),
            "p2p_cost_bytes": sum(p2p_cost_bytes(tensor, len(engine.ranks[a]),
                                                 len(engine.ranks[b]))
                                  for a, b, _ in engine.hand_offs)}


def migrator_check(engine, kept, batch, base, slow, speed, delta, counts, diff):
    """Algorithm 1 driving the engine: the port's `ProgressAwareMigrator` on
    the last adaptation's `migrator_kwargs` (the final plan; chunk costs F
    1, B 2, W 0.5 scaled by the adaptation's layer shares and speeds, with
    executor `slow`'s speed set to `speed` and Algorithm 1's `delta`), its
    migrations executed as a placement (`engine_placement`) on the batch
    the migration identity ran, optimizer off; the loss held to `base`
    within TOL_MIGRATION and at least one chunk moved; the iteration's
    launches counted on their own."""
    from repro_torch.core.scheduler.migration import ProgressAwareMigrator, engine_placement

    scheduler, adaptation = kept
    if adaptation.plan.summary() != engine.plan.summary():
        raise AssertionError(f"migrator: the adaptation's plan {adaptation.plan.summary()} is "
                             f"not the engine's {engine.plan.summary()}")
    speeds = {**adaptation.stage_speeds, slow: speed}
    kw = scheduler.migrator_kwargs(
        dataclasses.replace(adaptation, stage_speeds=speeds), n_mb=engine.plan.microbatches,
        chunk_base_cost=lambda cid: {"F": 1.0, "B": 2.0, "W": 0.5}[cid.kind])
    sim = ProgressAwareMigrator(**{**kw, "delta": delta}).run()
    placement = engine_placement(sim.migrations)
    if sim.status != "ok" or not sim.migrations:
        raise AssertionError(f"migrator: {sim.status}, moved {sim.migrations}")
    before = counts()
    placed = engine.run_iteration(batch, placement=placement)[0]
    torch.cuda.synchronize()
    launches = diff(counts(), before)
    if not abs(base - placed) <= TOL_MIGRATION:
        raise AssertionError(f"migrator placement: {base} vs {placed}")
    res = {"plan": engine.plan.summary(), "slow_executor": list(slow), "speed": speed,
           "delta": delta, "stage_speeds": {f"dp{r},pp{s}": v for (r, s), v in speeds.items()},
           "moved": [{"time": ev.time, "chunk": repr(ev.chunk), "src": list(ev.src),
                      "dst": list(ev.dst), "reason": ev.reason} for ev in sim.migrations],
           "placement": {repr(c): list(d) for c, d in placement.items()},
           "makespan": sim.makespan, "base": base, "placed": placed, "abs": abs(base - placed),
           "tol": TOL_MIGRATION, "launches": launches}
    log("pipeline migrator placement", json.dumps(res))
    return res


def checkpoint_phase(cfg, device):
    """Checkpoint and restart on the card, on the fp32 parity model: the
    pipeline driver 6 steps straight against 3 + save + restart + 3 (the
    same final loss), then a Fig. 8b recovery (both replicas of stage 0
    dead) from a checkpoint of a trained engine's state onto the card, bit
    for bit. Reports save and restore seconds and bytes."""
    import tempfile

    import repro_torch.launch.train as driver
    from repro_torch.checkpoint import CheckpointManager, save_checkpoint
    from repro_torch.core.recovery import recover_state
    from repro_torch.core.scheduler.plan import ParallelPlan, ReplicaPlan, StagePlan, initial_plan
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.engine.pipeline import PipelineEngine
    from repro_torch.train.optimizer import make_optimizer

    small, _ = parity_model(cfg)
    B = PIPE_PLAN["dp"] * PIPE_MICROBATCHES
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)

        def run(steps, where, *extra):
            return driver.run_pipeline(small, pipeline_args(
                driver, steps, PARITY_SEQ, B, device, "--ckpt-dir", str(root / where),
                "--ckpt-interval", str(CKPT_INTERVAL), *extra))

        straight = run(CKPT_STEPS, "straight")
        run(CKPT_STEPS // 2, "restart")
        restarted = run(CKPT_STEPS, "restart", "--resume")
        restart_err = abs(restarted["losses"][-1] - straight["losses"][-1])
        if len(restarted["losses"]) != CKPT_STEPS - CKPT_STEPS // 2 or not restart_err <= TOL_RESTART:
            raise AssertionError(f"restart: {restarted['losses']} vs {straight['losses']}")

        # Fig. 8b: stage 0 lost in both replicas; the state comes back from disk
        old = initial_plan(small.n_layers, PIPE_PLAN["dp"], 2, 1, microbatches=PIPE_MICROBATCHES)
        new = ParallelPlan(tuple(ReplicaPlan((StagePlan((), r.stages[0].layers), r.stages[1]))
                                 for r in old.replicas))
        engine = PipelineEngine(small, old, optimizer=make_optimizer("adamw", lr=1e-3),
                                devices=[device])
        engine.run_iteration(to_device(SyntheticPackedDataset(small, PARITY_SEQ, B, seed=0)
                                       .batch_at(0), device))
        state = {"params": engine.params_full, "opt": engine.opt_state, "step": engine.step}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(root / "fig8b", state, engine.step)
        save_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in path.glob("leaf_*.npy"))
        t0 = time.perf_counter()
        got, tp, step = recover_state(small, state, old_plan=old, new_plan=new, shardings=device,
                                      checkpoint_mgr=CheckpointManager(root / "fig8b"),
                                      dead_stages=[(0, 0), (1, 0)])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restart = restart_model_check(root, path, n_bytes, save_s, restore_s, device)
    want_leaves, got_leaves = ckpt_leaves(state), ckpt_leaves(got)
    exact = len(want_leaves) == len(got_leaves) and all(
        isinstance(g, torch.Tensor) and g.device == w.device and torch.equal(g, w)
        if isinstance(w, torch.Tensor) else g == w for w, g in zip(want_leaves, got_leaves))
    if not (tp.restore_required and step == engine.step and exact):
        raise AssertionError(f"Fig. 8b restore: required {tp.restore_required}, step {step}, "
                             f"bit-exact on the card {exact}")
    res = {"model": {"layers": small.n_layers, "d_model": small.d_model, "head_dim": small.head_dim},
           "seq_len": PARITY_SEQ, "batch": B, "straight_losses": straight["losses"],
           "restarted_losses": restarted["losses"], "restart_abs_err": restart_err,
           "tol": TOL_RESTART, "fig8b": {"moves": len(tp.moves), "restored_step": step,
                                         "leaves": len(want_leaves), "bit_exact": exact},
           "save_seconds": save_s, "restore_seconds": restore_s, "bytes": n_bytes,
           "restart_model": restart}
    log("checkpoint", json.dumps(res))
    return res


def manifest_bytes(step_dir):
    """Bytes of a checkpoint's leaves by its manifest, each dtype's size
    from torch's dtype of the same name."""
    leaves = json.loads((Path(step_dir) / "MANIFEST.json").read_text())["leaves"]
    return sum(getattr(torch, leaf["dtype"]).itemsize * math.prod(leaf["shape"])
               for leaf in leaves)


def restart_model_check(root, path, n_bytes, save_s, restore_s, device):
    """The restart cost model priced from the Fig. 8b checkpoint's manifest
    and from a small checkpoint with a bf16 leaf (a name plain numpy does
    not know): the manifest's bytes, no more than the leaf files' on disk.
    The disk's save and restore GB/s (the card's machine, warm reads) stand
    beside the model's aggregate rates."""
    from repro_torch.checkpoint import RestartCostModel, save_checkpoint

    model = RestartCostModel.from_manifest(path.parent)
    bf16_path = save_checkpoint(root / "bf16", {
        "h": torch.ones(33, 7, dtype=torch.bfloat16, device=device),
        "w": torch.ones(5, 3, device=device)}, 0)
    bf16 = RestartCostModel.from_manifest(bf16_path.parent)
    checks = {}
    for name, m, step_dir in (("fig8b", model, path), ("bf16", bf16, bf16_path)):
        want = manifest_bytes(step_dir)
        on_disk = sum(f.stat().st_size for f in step_dir.glob("leaf_*.npy"))
        checks[name] = {"priced_bytes": m.state_gb * 1e9, "manifest_bytes": want,
                        "leaf_file_bytes": on_disk}
        if not (round(m.state_gb * 1e9) == want and want <= on_disk):
            raise AssertionError(f"restart model {name}: {checks[name]}")
    if checks["bf16"]["manifest_bytes"] != 33 * 7 * 2 + 5 * 3 * 4:
        raise AssertionError(f"restart model: bf16 leaf not at 2 bytes {checks['bf16']}")
    res = {"checks": checks, "state_gb": model.state_gb,
           "save_cost_s": model.save_cost_s(), "restart_cost_s": model.restart_cost_s(),
           "model_write_gbps": model.write_gbps, "model_read_gbps": model.read_gbps,
           "card_machine_disk_save_gbps": n_bytes / save_s / 1e9,
           "card_machine_disk_restore_gbps": n_bytes / restore_s / 1e9}
    log("restart model:", json.dumps(res))
    return res


def cluster_phase():
    """The port's cluster simulator on the card's host (Python and numpy;
    it loads no torch of its own): the simulator golden with both engines,
    its exact fields equal and its floats within TOL_SIM_REL, then the
    reference example's 256-device run of four policies, each policy's
    simulated samples/s within TOL_SIM_REL of the CPU's. Samples/s are the
    simulator's modelled seconds, not a time of the card."""
    from repro_torch.cluster import scenarios
    from repro_torch.cluster.simulator import SimConfig, TrainingSim

    res = {"numpy": np.__version__, "golden": {}, "example": {}}
    golden = json.loads((Path(__file__).resolve().parent / "tests" / "golden" /
                         "simulator_golden.json").read_text())
    name, span = GOLDEN_SIM["scenario"]
    for engine in ("fast", "python"):
        t0 = time.perf_counter()
        sim = TrainingSim("resihp", SimConfig(**GOLDEN_SIM["cfg"]), engine=engine,
                          policy_kwargs=GOLDEN_SIM["policy_kwargs"])
        compiled = sim.apply_scenario(scenarios.get(name, span=span))
        sim.run(GOLDEN_SIM["iters"], stop_on_abort=False)
        got = json.loads(json.dumps({
            "compiled_events": compiled.as_tuples(),
            "fired_events": [ev.as_tuple() for ev in sim.event_log],
            "cluster_log": [[t, kind, int(target), float(value)]
                            for t, kind, target, value in sim.cluster.events],
            "n_iters": len(sim.trace), "aborted": sim.aborted,
            "avg_throughput": sim.avg_throughput(skip=2),
            "session_throughput": sim.session_throughput(skip=2),
            "t_starts": [r.t_start for r in sim.trace],
            "durations": [r.duration for r in sim.trace]}))
        exact = ("compiled_events", "fired_events", "cluster_log", "n_iters", "aborted")
        differ = [k for k in exact if got[k] != golden[k]] + [
            k for k in ("avg_throughput", "session_throughput", "t_starts", "durations")
            if np.shape(got[k]) != np.shape(golden[k])
            or not np.allclose(got[k], golden[k], rtol=TOL_SIM_REL, atol=0.0)]
        res["golden"][engine] = {"wall_seconds": time.perf_counter() - t0,
                                 "n_iters": got["n_iters"], "fired": len(got["fired_events"]),
                                 "avg_throughput": got["avg_throughput"], "differ": differ}
        if differ:
            raise AssertionError(f"simulator golden ({engine} engine, numpy {np.__version__}): "
                                 f"first field that differs {differ[0]}")
    for policy, want in EXAMPLE_SIM["samples_per_s"].items():
        t0 = time.perf_counter()
        sim = TrainingSim(policy, SimConfig(**EXAMPLE_SIM["cfg"]))
        sim.apply_scenario(scenarios.get(EXAMPLE_SIM["scenario"]))
        sim.run(EXAMPLE_SIM["iters"], stop_on_abort=False)
        got = sim.avg_throughput(skip=2)
        res["example"][policy] = {"simulated_samples_per_s": got,
                                  "false_alarms": sim.detector.stats.false_alarms,
                                  "aborted": sim.aborted,
                                  "host_wall_seconds": time.perf_counter() - t0}
        if not abs(got - want) <= TOL_SIM_REL * abs(want):
            raise AssertionError(f"example {policy}: {got!r} simulated samples/s against "
                                 f"{want!r} (numpy {np.__version__})")
    log("cluster:", json.dumps(res))
    return res


def ckpt_leaves(tree):
    """Leaves of a state tree, dict keys sorted (the checkpoint's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in ckpt_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in ckpt_leaves(v)]
    return [tree]


def sass_by_function(lib):
    """{mangled kernel name: its SASS lines} of a library (cuobjdump, beside nvcc)."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def sass_count(lib, opcode):
    """Lines of the library's SASS with `opcode`."""
    return sum(opcode in line for lines in sass_by_function(lib).values() for line in lines)


def ptxas_by_function(log):
    """{mangled kernel name: registers and spill bytes} from a `ptxas -v` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m[1])
    return out


# per-kernel build gates: (what, kernel source's record, kernels, head widths,
# the SASS opcode every one of them must show): the bf16 head_dim 256
# backward's dK/dV and dQ kernels on wgmma, the bf16 head_dim 80 forward,
# dK/dV and dQ kernels (five 16-column chunks under the 32-byte swizzle) on
# wgmma, the fp32 forward on TF32 tensor-core products at every head width,
# and the fp32 backward's dK/dV and dQ kernels at every width its paths run;
# head_dim 64 is whisper-medium's, forward and backward, bf16 and fp32: in
# bf16 the narrow kernels (64-row forward CTAs, the dQ kernel with the delta
# pass, the persistent dK/dV kernel), which head_dim 16 and 32 share
BUILD_GATES = (
    ("head_dim_256_backward_build", "BWD_SM90_WIDE",
     ("bwd_sm90_dkdv_split_kernel", "bwd_sm90_dq_kernel"), (256,), ("HGMMA",)),
    ("head_dim_80_forward_build", "SM90", ("packed_flash_attn_sm90_kernel",), (80,), ("HGMMA",)),
    ("head_dim_80_backward_build", "BWD_SM90", ("bwd_sm90_dkdv_kernel", "bwd_sm90_dq_kernel"),
     (80,), ("HGMMA",)),
    ("fp32_forward_build", "FWD_TF32", ("packed_flash_attn_tf32_kernel",),
     (16, 32, 64, 80, 128, 256), ("HMMA", "TF32")),
    ("head_dim_64_forward_build", "SM90_NARROW", ("packed_flash_attn_sm90_narrow_kernel",),
     (16, 32, 64), ("HGMMA",)),
    ("head_dim_64_backward_build", "BWD_SM90_NARROW",
     ("bwd_sm90_dq_narrow_kernel", "bwd_sm90_dkdv_narrow_kernel"), (16, 32, 64), ("HGMMA",)),
    ("fp32_backward_build", "BWD_TF32", ("bwd_tf32_dkdv_kernel", "bwd_tf32_dq_kernel"),
     (64, 80, 128, 256), ("HMMA", "TF32")),
)


def spill_check(sources):
    """Every function of every library's ptxas report, by source: fails on
    any spill, or on a library whose report names no function. Returns the
    functions reported by source."""
    from repro_torch.kernels import build

    report = {src: ptxas_by_function(build.build_log(src)) for src in sources}
    spilled = {f"{src}:{name}": r for src, funcs in report.items() for name, r in funcs.items()
               if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    if spilled or not all(report.values()):
        raise AssertionError(f"ptxas reports spills (or no function) in {spilled or report}")
    return {src: len(funcs) for src, funcs in report.items()}


def kernel_build_check(record_name, knames, head_dims, opcode):
    """Each kernel's instantiation at each head width: the SASS lines that
    hold every word of `opcode`, and its registers and spills from ptxas;
    fails where there is no such line or any spill."""
    from repro_torch.kernels import build
    import repro_torch.kernels.packed_flash_attn as pfa

    source = getattr(pfa, record_name).source
    sass = sass_by_function(build.library_path(source))
    ptxas = ptxas_by_function(build.build_log(source))
    report = {}
    for kname in knames:
        for dh in head_dims:
            # every instance at this width (the narrow kernels have one a mode:
            # a second template argument, `Lb0`/`Lb1` in the mangled name)
            found = [f for f in sass if kname in f and f"ILi{dh}E" in f]
            if not found or not all(f in ptxas for f in found):
                raise AssertionError(f"{kname}<{dh}>: {len(found)} functions in the SASS "
                                     f"({found}), in the ptxas report: "
                                     f"{[f in ptxas for f in found]}")
            for func in found:
                rest = func.split(f"ILi{dh}E", 1)[1]
                label = f"{kname}<{dh}>" if rest.startswith("EEv") else (
                    f"{kname}<{dh}, {rest.split('E', 1)[0]}>")
                res = ptxas[func]
                row = {"function": func, "opcode": " ".join(opcode),
                       "instructions": sum(all(w in line for w in opcode) for line in sass[func]),
                       **res}
                if row["instructions"] == 0:
                    raise AssertionError(f"{label}: no {' '.join(opcode)} instruction in its SASS")
                if res.get("spill_stores", 1) or res.get("spill_loads", 1):
                    raise AssertionError(f"{label}: ptxas reports spills {res}")
                report[label] = row
    return report


TIMING_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_kernels",
               "max_abs_err", "shape", "kv_heads", "window", "dtype", "splits", "ms_by_splits",
               "ms_by_kernel", "share_by_kernel", "bound_3xtf32_ms", "bound_3xtf32_share")


def fp32_bwd_extra(row, full=False):
    """The fp32 backward's own fields of a `kernels` entry: tiles, time by
    kernel, splits (and times at every split), the 3xTF32 bound; with
    `full`, the case's times too."""
    keys = ("tiles", "dq_tiles", "ms_by_kernel", "splits", "ms_by_splits",
            "bound_3xtf32_ms", "bound_3xtf32_share", "interleaved", "interleaved_ratio")
    if full:
        keys += ("shape", "kv_heads", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
    return {key: row.get(key) for key in keys}


def kernel_entries(record):
    """The `kernels` line: one entry per kernel source, head width and GQA
    group that a main path launched, its launches counted in those runs, its
    times from the kernel phases at a main path's shape; other shapes of the
    same kernel under `other_cases`."""
    from repro_torch.kernels.packed_flash_attn import BWD_SM90, BWD_TF32, FWD_TF32, SM90

    kern, fk, fam, fp32, moe, mm = (record["kernel"], record["family_kernel"], record["family"],
                                    record["fp32_path"], record["moe"], record["multimodal"])
    qmoe, vl, wh = "qwen3-moe-30b-a3b", "qwen2-vl-7b", "whisper-medium"
    jam = "jamba-1.5-large-398b"
    rec = record["recurrent"]
    mk = {k.removeprefix(f"{wh}_"): row for k, row in mm["kernel"].items()}  # whisper's regimes

    def regimes(tag, bwd=""):  # whisper's regime rows other than the encoder's training one
        return {name: {k: mk[f"{name}_{tag}{bwd}"].get(k) for k in TIMING_KEYS + ("causal", "keys")}
                for name in ("encoder_serve", "decoder_self_train", "cross_train", "cross_serve")}

    def entry(name, source, row, by_path, *, others=(), **extra):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": "src/repro/kernels/packed_flash_attn.py:39",
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "wrapper_event_ms": row["wrapper_event_ms"],
                "shape": row["shape"], "kv_heads": row.get("kv_heads"), "dtype": row["dtype"],
                "other_cases": {o: {k: fk[o].get(k) for k in TIMING_KEYS} for o in others},
                **extra}

    def fwd(res, source):  # forward launches of a train or pipeline run
        return res["launches"][source]

    def bwd(res, source):
        return res["launches"][f"backward[{source}]"]

    def served(res):
        return res["main_path_launches_by_source"][SM90.source]

    migrator = record["pipeline"]["migration"]["migrator"]  # runs of their own (phases 7, 8)
    bf16_step = record["train"]["bf16_accumulation"]
    train_prof = record["train"]["profile"]  # the backward's device time inside the train step
    train_bwd_ms = (train_prof["group_shares"]["attention_backward"]
                    * train_prof["device_seconds_per_call"] * 1e3
                    / record["train"]["launches_per_step"][f"backward[{BWD_SM90.source}]"])
    return [
        # bf16, head_dim 128: qwen3-8b's heads (H 32, K 8), at the serving shape
        entry("packed_flash_attention", SM90.source, kern["serving"],
              {"qwen3-8b serve": served(record["serve"]),
               "qwen3-8b train": fwd(record["train"], SM90.source),
               "qwen3-8b pipeline": fwd(record["pipeline"], SM90.source),
               "qwen3-8b stage-mesh pipeline": fwd(record["sharding"]["pipeline"], SM90.source),
               "qwen3-8b migrator placement": fwd(migrator, SM90.source),
               "qwen3-8b train, bf16 accumulation": fwd(bf16_step, SM90.source)},
              head_dim=128, wrapper_device_ms=kern["serving"]["wrapper_device_ms"]),
        entry("packed_flash_attention[GQA group 1]", SM90.source, fk["llama2-7b_bf16"],
              {"llama2-7b serve": served(fam["llama2-7b_serve"]),
               "llama2-7b pipeline": fwd(fam["llama2-7b_pipeline"], SM90.source)}, head_dim=128),
        entry("packed_flash_attention[GQA group 7]", SM90.source, fk["qwen2.5-7b_bf16"],
              {"qwen2.5-7b serve": served(fam["qwen2.5-7b_serve"]),
               f"{vl} serve": served(mm[f"{vl}_serve"]),
               f"{vl} train": fwd(mm[f"{vl}_train"], SM90.source)}, head_dim=128),
        # whisper-medium's heads (16/16, head_dim 64) in its three regimes: the
        # non-causal encoder, the causal decoder and the cross-attention
        entry("packed_flash_attention[head_dim 64]", SM90.source, mk["encoder_train_bf16"],
              {f"{wh} serve": served(mm[f"{wh}_serve"]),
               f"{wh} train": fwd(mm[f"{wh}_train"], SM90.source)}, head_dim=64,
              launches_by_regime={"serve prefill": mm[f"{wh}_serve"]["prefill_calls_by_regime"],
                                  "train": mm[f"{wh}_train"]["forward_calls_by_regime"]},
              regimes=regimes("bf16")),
        entry("packed_flash_attention[head_dim 256]", SM90.source, fk["gemma3-1b_bf16"],
              {"gemma3-1b serve": served(fam["gemma3-1b_serve"]),
               "gemma3-1b train": fwd(fam["gemma3-1b_train"], SM90.source),
               "gemma3-1b pipeline": fwd(fam["gemma3-1b_pipeline"], SM90.source)},
              others=("gemma3-4b_bf16",), head_dim=256),
        entry("packed_flash_attention[head_dim 80]", SM90.source, fk["h2o-danube-1.8b_bf16"],
              {"h2o-danube-1.8b train": fwd(fam["h2o-danube-1.8b_train"], SM90.source)},
              head_dim=80),
        # the MoE family's heads: qwen3-moe 32/4 (group 8), grok-1 48/8 (group 6)
        entry("packed_flash_attention[GQA group 8]", SM90.source, fk[f"{qmoe}_bf16"],
              {f"{qmoe} serve": served(moe[f"{qmoe}_serve"]),
               f"{qmoe} train": fwd(moe[f"{qmoe}_train"], SM90.source),
               f"{qmoe} pipeline": fwd(moe[f"{qmoe}_pipeline"], SM90.source)},
              others=(f"{jam}_bf16",), head_dim=128),
        # jamba-1.5-large-398b's heads (64/8, group 8): one attention layer a period
        entry("packed_flash_attention[64/8 heads]", SM90.source, fk[f"{jam}_bf16"],
              {f"{jam} serve": served(rec[f"{jam}_serve"]),
               f"{jam} sharded serve": record["sharding"][f"{jam}_serve"]["prefill_launches"][
                   SM90.source]}, head_dim=128),
        entry("packed_flash_attention[GQA group 6]", SM90.source, fk["grok-1-314b_bf16"],
              {"grok-1-314b serve": served(moe["grok-1-314b_serve"])}, head_dim=128),
        # fp32: the parity paths, at head_dim 128, 256 and 80, each at its 2 x 256 batch
        *(entry(f"packed_flash_attention[float32{tag}]", FWD_TF32.source, fp32[arch]["kernel"],
                {**{f"{a} parity": fp32[a]["launches"][FWD_TF32.source]
                    + fp32[a]["train_step_launches"][FWD_TF32.source]
                    for a in (arch, qmoe, vl, jam) if a == arch or arch == "qwen3-8b"},
                 **({f"{jam} sharded parity": record["sharding"][f"{jam}_fp32_parity"][
                     "launches"][FWD_TF32.source]} if arch == "qwen3-8b" else {})},
                others=others, head_dim=fp32[arch]["head_dim"],
                wrapper_device_ms=fp32[arch]["kernel"]["wrapper_device_ms"],
                **{key: fp32[arch]["kernel"][key] for key in (
                    "bound_3xtf32_ms", "bound_3xtf32_share", "splits", "ms_by_splits",
                    "microbatches")},
                **({"ragged": {key: kern["fp32_ragged"].get(key) for key in TIMING_KEYS}}
                   if arch == "qwen3-8b" else {}))
          for arch, tag, others in (
              ("qwen3-8b", "", ("llama2-7b_fp32", "qwen2.5-7b_fp32", f"{qmoe}_fp32",
                                "grok-1-314b_fp32", f"{jam}_fp32")),
              ("gemma3-1b", ", head_dim 256", ("gemma3-1b_fp32", "gemma3-4b_fp32")),
              ("h2o-danube-1.8b", ", head_dim 80", ("h2o-danube-1.8b_fp32",)))),
        entry("packed_flash_attention[float32, head_dim 64]", FWD_TF32.source,
              mk["encoder_train_fp32"],
              {f"{wh} parity": fp32[wh]["launches"][FWD_TF32.source]
               + fp32[wh]["train_step_launches"][FWD_TF32.source]}, head_dim=64,
              regimes=regimes("fp32"),
              **{key: mk["encoder_train_fp32"].get(key) for key in (
                  "bound_3xtf32_ms", "bound_3xtf32_share", "splits")}),
        # the backward: per launch, at the train paths' micro-batches
        entry("packed_flash_attention_backward", BWD_SM90.source,
              per_launch(kern["train_bwd"]),
              {"qwen3-8b train": bwd(record["train"], BWD_SM90.source),
               "qwen3-8b pipeline": bwd(record["pipeline"], BWD_SM90.source),
               "qwen3-8b stage-mesh pipeline": bwd(record["sharding"]["pipeline"],
                                                   BWD_SM90.source),
               "qwen3-8b migrator placement": bwd(migrator, BWD_SM90.source),
               "qwen3-8b train, bf16 accumulation": bwd(bf16_step, BWD_SM90.source)},
              head_dim=128, train_step_ms_per_launch=train_bwd_ms),
        entry("packed_flash_attention_backward[GQA group 8]", BWD_SM90.source,
              fk[f"{qmoe}_bf16_bwd"],
              {f"{qmoe} train": bwd(moe[f"{qmoe}_train"], BWD_SM90.source),
               f"{qmoe} pipeline": bwd(moe[f"{qmoe}_pipeline"], BWD_SM90.source)},
              others=("grok-1-314b_bf16_bwd", f"{jam}_bf16_bwd"), head_dim=128),
        entry("packed_flash_attention_backward[GQA group 1]", BWD_SM90.source,
              fk["llama2-7b_bf16_bwd"],
              {"llama2-7b pipeline": bwd(fam["llama2-7b_pipeline"], BWD_SM90.source)},
              head_dim=128),
        entry("packed_flash_attention_backward[GQA group 7]", BWD_SM90.source,
              fk["qwen2.5-7b_bf16_bwd"],
              {f"{vl} train": bwd(mm[f"{vl}_train"], BWD_SM90.source)}, head_dim=128),
        # whisper-medium: each launch runs one of the three regimes, a third each
        entry("packed_flash_attention_backward[head_dim 64]", BWD_SM90.source,
              mk["encoder_train_bf16_bwd"],
              {f"{wh} train": bwd(mm[f"{wh}_train"], BWD_SM90.source)}, head_dim=64,
              regimes=regimes("bf16", "_bwd"),
              **{key: mk["encoder_train_bf16_bwd"].get(key) for key in (
                  "tiles", "dq_tiles", "ms_by_kernel", "share_by_kernel")}),
        entry("packed_flash_attention_backward[head_dim 256]", BWD_SM90.source,
              fk["gemma3-1b_bf16_bwd"],
              {"gemma3-1b train": bwd(fam["gemma3-1b_train"], BWD_SM90.source),
               "gemma3-1b pipeline": bwd(fam["gemma3-1b_pipeline"], BWD_SM90.source)},
              others=("gemma3-1b_bf16_global_bwd", "gemma3-4b_bf16_bwd",
                      "gemma3-4b_bf16_global_bwd"), head_dim=256,
              **{key: fk["gemma3-1b_bf16_bwd"].get(key) for key in
                 ("tiles", "dq_tiles", "ms_by_kernel", "splits", "ms_by_splits")}),
        entry("packed_flash_attention_backward[head_dim 80]", BWD_SM90.source,
              fk["h2o-danube-1.8b_bf16_bwd"],
              {"h2o-danube-1.8b train": bwd(fam["h2o-danube-1.8b_train"], BWD_SM90.source)},
              head_dim=80, **{key: fk["h2o-danube-1.8b_bf16_bwd"].get(key) for key in
                              ("tiles", "dq_tiles", "ms_by_kernel")}),
        entry("packed_flash_attention_backward[float32]", BWD_TF32.source,
              per_launch(kern["fp32_parity_bwd"]),
              {**{f"{a} parity": fp32[a]["train_step_backward_launches"][BWD_TF32.source]
                  for a in ("qwen3-8b", qmoe, vl, jam)},
               f"{jam} sharded parity": record["sharding"][f"{jam}_fp32_parity"]["launches"][
                   BWD_TF32.source]},
              others=("llama2-7b_fp32_bwd", "qwen2.5-7b_fp32_bwd", f"{qmoe}_fp32_bwd",
                      "grok-1-314b_fp32_bwd", f"{jam}_fp32_bwd"), head_dim=128,
              **fp32_bwd_extra(per_launch(kern["fp32_parity_bwd"])),
              ragged=fp32_bwd_extra(kern["fp32_ragged_bwd"], full=True)),
        entry("packed_flash_attention_backward[float32, head_dim 256]", BWD_TF32.source,
              fk["gemma3-1b_fp32_bwd"],
              {"gemma3-1b parity":
               fp32["gemma3-1b"]["train_step_backward_launches"][BWD_TF32.source]},
              others=("gemma3-4b_fp32_bwd",), head_dim=256,
              **fp32_bwd_extra(fk["gemma3-1b_fp32_bwd"])),
        entry("packed_flash_attention_backward[float32, head_dim 80]", BWD_TF32.source,
              fk["h2o-danube-1.8b_fp32_bwd"],
              {"h2o-danube-1.8b parity":
               fp32["h2o-danube-1.8b"]["train_step_backward_launches"][BWD_TF32.source]},
              head_dim=80, **fp32_bwd_extra(fk["h2o-danube-1.8b_fp32_bwd"])),
        entry("packed_flash_attention_backward[float32, head_dim 64]", BWD_TF32.source,
              mk["encoder_train_fp32_bwd"],
              {f"{wh} parity": fp32[wh]["train_step_backward_launches"][BWD_TF32.source]},
              head_dim=64, regimes=regimes("fp32", "_bwd"),
              **fp32_bwd_extra(mk["encoder_train_fp32_bwd"])),
    ]


def moe_phases(record, device):
    """The MoE family, into `record`: the fp32 parity path with the full
    config's Adafactor (`record["fp32_path"]`), then (`record["moe"]`) one
    layer twice, qwen3-moe-30b-a3b serving at full depth, training cut to
    MOE_TRAIN_LAYERS and under the ResiHP runtime's faults; grok-1-314b
    serving cut to GROK_LAYERS."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import tree_leaves

    moe = record["moe"] = {}
    qmoe = get_arch("qwen3-moe-30b-a3b")
    record["fp32_path"][qmoe.arch_id] = fp32_phase(qmoe, device, optimizer="adafactor",
                                                   time_kernel=False)
    moe["layer"] = moe_layer_phase(qmoe, device)
    torch.cuda.empty_cache()
    for mcfg in (qmoe, dataclasses.replace(get_arch("grok-1-314b"), n_layers=GROK_LAYERS)):
        t0 = time.perf_counter()
        params = init_params(mcfg, seed=0, dtype=torch.bfloat16, device=device)
        torch.cuda.synchronize()
        log(f"{mcfg.arch_id}: {mcfg.n_layers} layers, d_model {mcfg.d_model}, "
            f"{sum(p.numel() for p in tree_leaves(params))} parameters, "
            f"init {time.perf_counter() - t0:.1f} s")
        moe[f"{mcfg.arch_id}_serve"] = serve_phase(mcfg, params, device,
                                                   new_tokens=PAPER_NEW_TOKENS)
        del params
        torch.cuda.empty_cache()
        if mcfg is qmoe:
            moe[f"{qmoe.arch_id}_train"] = train_phase(qmoe, device, layers=MOE_TRAIN_LAYERS,
                                                       steps=FAMILY_TRAIN_STEPS,
                                                       fit=FAMILY_TRAIN_FIT)
            torch.cuda.empty_cache()
            moe[f"{qmoe.arch_id}_pipeline"] = pipeline_phase(qmoe, device,
                                                             PIPE_SPECS[qmoe.arch_id])
            torch.cuda.empty_cache()


def recurrent_phases(record, device, served):
    """The recurrent families, into `record`: the fp32 parity paths of
    reduced xlstm-1.3b (AdamW) and reduced jamba-1.5-large-398b (the fp32
    attention kernels at head_dim 128, the full config's Adafactor) into
    `record["fp32_path"]`; then (`record["recurrent"]`) jamba's Mamba layer
    (`mamba_layer_phase`), xlstm-1.3b serving at full depth, jamba cut to
    JAMBA_LAYERS serving, and xlstm-1.3b cut to XLSTM_TRAIN_LAYERS training
    for XLSTM_TRAIN_STEPS steps, each with its loops' launches per layer and
    share of the path's device time (`loop_profile`, `loop_shares`). `served`
    gets each serving's `keep` (`serve_phase`) under its arch."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import tree_leaves

    rec = record["recurrent"] = {"seconds": {}}
    t_start = time.perf_counter()

    def mark(name):  # seconds since the phases began, after each
        rec["seconds"][name] = time.perf_counter() - t_start
        log(f"recurrent: {rec['seconds'][name]:.1f} s after {name}")

    xcfg, jcfg = get_arch("xlstm-1.3b"), get_arch("jamba-1.5-large-398b")
    record["fp32_path"][xcfg.arch_id] = fp32_phase(xcfg, device, time_kernel=False)
    # weight seed 1: seed 0 gives one of its routers a top-k gap of 2.9e-6
    record["fp32_path"][jcfg.arch_id] = fp32_phase(jcfg, device, optimizer="adafactor",
                                                   time_kernel=False, seed=1)
    mark("fp32 paths")
    rec["mamba_layer"] = mamba_layer_phase(jcfg, device)
    torch.cuda.empty_cache()
    mark("mamba layer")
    jcut = dataclasses.replace(jcfg, n_layers=JAMBA_LAYERS, period=jcfg.period[:JAMBA_LAYERS])
    # xlstm-1.3b's prefill device time is composed from its layers' profiles
    for cfg, new_tokens, profiled in ((xcfg, NEW_TOKENS, False), (jcut, PAPER_NEW_TOKENS, True)):
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
        torch.cuda.synchronize()
        log(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{sum(p.numel() for p in tree_leaves(params))} parameters, "
            f"init {time.perf_counter() - t0:.1f} s")
        serve = serve_phase(cfg, params, device, new_tokens=new_tokens,
                            profile_prefill=profiled, keep=served.setdefault(cfg.arch_id, {}))
        del params
        torch.cuda.empty_cache()
        mark(f"{cfg.arch_id} serve")
        loops = loop_profile(cfg, device, SERVE_B, PROMPT, train=False)
        if not profiled:
            serve["prefill_profile"] = composed_profile(cfg, loops, ("layer_forward",),
                                                        serve["prefill_seconds"])
        serve["loops"] = {"prefill": loop_shares(cfg, loops, serve["prefill_profile"],
                                                 passes={"scan_forward": 1}),
                          "decode": loop_shares(cfg, loops, serve["decode_profile"], passes={}),
                          "by_mixer": loops}
        log(f"{cfg.arch_id} serve loops", json.dumps({k: v for k, v in serve["loops"].items()
                                                     if k != "by_mixer"}))
        rec[f"{cfg.arch_id}_serve"] = serve
        torch.cuda.empty_cache()
        mark(f"{cfg.arch_id} serve loops")
    # a profile of a whole step traces ~2.7 M kernels: 573 s where the step
    # took 66-113 s (NVIDIA H100 80GB HBM3, 700 W), so the step's device time
    # is composed from its layers' profiles (`loop_profile`: a layer runs
    # forward, then remat's recompute and the backward), the LM head, loss
    # and AdamW left out
    train = train_phase(xcfg, device, layers=XLSTM_TRAIN_LAYERS, steps=XLSTM_TRAIN_STEPS,
                        fit=None, batch=1, microbatches=1, profile=False,
                        warmup=XLSTM_TRAIN_WARMUP)
    torch.cuda.empty_cache()
    mark(f"{xcfg.arch_id} train")
    xcut = dataclasses.replace(xcfg, n_layers=XLSTM_TRAIN_LAYERS)
    loops = loop_profile(xcfg, device, 1, TRAIN_SEQ, train=True, scale=XLSTM_TRAIN_SCALE)
    train["profile"] = composed_profile(xcut, loops, ("layer_forward", "layer_train"),
                                        train["step_seconds_mean"])
    train["loops"] = {"step": loop_shares(xcut, loops, train["profile"],
                                          passes={"scan_forward": 1, "scan_train": 1}),
                      "by_mixer": loops}
    log(f"{xcfg.arch_id} train loops", json.dumps(train["loops"]["step"]))
    rec[f"{xcfg.arch_id}_train"] = train
    torch.cuda.empty_cache()
    mark(f"{xcfg.arch_id} train loops")


def multimodal_kernel_phase(device, tags=("bf16", "fp32")):
    """The kernels in the regimes whisper-medium runs them, at its heads (16
    query and 16 KV heads, head_dim 64), bf16 and fp32 (or the dtypes of
    `tags`), forward and backward, each against the plain version and
    timed beside its bound, the plain version and SDPA with a boolean
    mask: the encoder's non-causal self-attention at serving's 4 x 1500
    frames and at the training batch's 1 x 4096 packed clips, the decoder's
    causal self-attention at 1 x 1024, and the cross-attention at 1 x 1024
    queries over 1 x 4096 keys (the training row, whose last decoder
    document is given a segment id no clip has: exactly 0 out and 0
    gradient) and at 4 x 64 over 4 x 1500 (serving)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.multimodal import enc_dec_batch

    cfg = get_arch("whisper-medium")
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    raw = enc_dec_batch(cfg, WHISPER_TRAIN_FRAMES, WHISPER_TRAIN_FRAMES // cfg.dec_ratio, 1,
                        seed=0, clip_frames=WHISPER_CLIPS)
    enc_seg, enc_pos, dec_seg, dec_pos = (torch.from_numpy(raw[k]).to(device) for k in (
        "enc_segment_ids", "enc_positions", "dec_segment_ids", "dec_positions"))
    orphan = dec_seg == dec_seg.max()  # a transcript without its clip
    dec_seg = torch.where(orphan, dec_seg.max() + 1, dec_seg)
    enc_abs = torch.arange(WHISPER_TRAIN_FRAMES, dtype=torch.int32, device=device)[None]
    dec_abs = torch.arange(dec_seg.shape[1], dtype=torch.int32, device=device)[None]

    def ones(B, S):
        return (torch.ones((B, S), dtype=torch.int32, device=device),
                torch.arange(S, dtype=torch.int32, device=device).repeat(B, 1))
    serve_enc, serve_dec = ones(SERVE_B, WHISPER_FRAMES), ones(SERVE_B, MM_CROSS_QUERIES)
    # (name, queries (seg, pos), keys (seg, pos) or None: the queries', causal)
    cases = (("encoder_serve", serve_enc, None, False),
             ("encoder_train", (enc_seg, enc_pos), None, False),
             ("decoder_self_train", (dec_seg, dec_pos), None, True),
             ("cross_train", (dec_seg, dec_abs), (enc_seg, enc_abs), False),
             ("cross_serve", serve_dec, (serve_enc[0], serve_enc[1]), False))
    g = torch.Generator(device=device)
    g.manual_seed(64)
    rows = {}
    for dtype, tol, tag in ((torch.bfloat16, TOL_BF16, "bf16"), (torch.float32, TOL_FP32, "fp32")):
        if tag not in tags:
            continue
        for name, (seg, pos), keys, causal in cases:
            B, Sq = seg.shape
            Sk = Sq if keys is None else keys[0].shape[1]
            q = torch.randn((B, Sq, H, dh), generator=g, device=device).to(dtype)
            k, v = (torch.randn((B, Sk, K, dh), generator=g, device=device).to(dtype)
                    for _ in range(2))
            label = f"whisper-medium_{name}_{tag}"
            kw = {"time_it": True, "causal": causal, "keys": keys}
            rows[label] = kernel_case(label, q, k, v, seg, pos, tol, time_masked=False, **kw)
            rows[f"{label}_bwd"] = backward_case(f"{label}_bwd", q, k, v, seg, pos, tol, **kw)
            if name == "cross_train" and not rows[label]["rows_without_key"] >= int(orphan.sum()):
                raise AssertionError(f"{label}: the transcript without its clip sees a key")
            del q, k, v
        torch.cuda.empty_cache()
    return rows


def multimodal_train_batch(cfg, index):
    """Batch `index` of the family's training path: 2 rows (one a micro-batch)."""
    from repro_torch.data.multimodal import enc_dec_batch, vlm_batch

    if cfg.enc_dec:
        return enc_dec_batch(cfg, WHISPER_TRAIN_FRAMES, WHISPER_TRAIN_FRAMES // cfg.dec_ratio,
                             TRAIN_BATCH, seed=0, clip_frames=WHISPER_CLIPS, index=index)
    return vlm_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0, vision_len=VLM_TRAIN_VISION,
                     grid=VLM_TRAIN_GRID, index=index)


def multimodal_train_phase(cfg, device, *, layers=None, steps=FAMILY_TRAIN_STEPS):
    """A VLM or encoder-decoder at full width (cut to `layers`, None: full
    depth) trained for `steps` steps by `train_step.build_train_step` (fp32
    masters, bf16 compute, remat, TRAIN_MICROBATCHES micro-batches of one
    row; `optimizer_for`'s optimizer) on `multimodal_train_batch` batches,
    through the bf16 forward and backward kernels. Checks every step's
    launches (each micro-batch: every attention call's forward kernel twice,
    forward and remat recompute, its backward kernel once), no plain call,
    step 0's loss against `loss_fn` on the same parameters and micro-batches,
    every parameter leaf's step-0 gradient finite and nonzero, and every
    loss finite; reports step times, throughput, peak memory and the device
    profile of step TRAIN_PROFILED_STEP."""
    from repro_torch.models.model import loss_fn
    from repro_torch.train.optimizer import optimizer_for, tree_leaves
    from repro_torch.train.train_step import build_train_step, init_train_state

    tcfg = cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)  # depth only
    mb, calls = TRAIN_MICROBATCHES, attention_calls(tcfg)
    torch.cuda.reset_peak_memory_stats()
    opt = optimizer_for(tcfg, lr=1e-3)
    state = init_train_state(0, tcfg, opt, device=device)
    step_fn = build_train_step(tcfg, opt, microbatches=mb)
    n = TRAIN_BATCH // mb
    with torch.no_grad():
        first = to_device(multimodal_train_batch(tcfg, 0), device)
        loss0_fn = sum(float(loss_fn(tcfg, state["params"], {k: v[i * n:(i + 1) * n]
                                                             for k, v in first.items()})[0])
                       for i in range(mb)) / mb
    del first

    def counts():
        return {**read_counts(), **{f"backward[{k}]": v for k, v in read_backward_counts().items()},
                "plain_calls": plain["plain_calls"]}
    want = bf16_launches(tcfg.head_dim, forward=2 * calls * mb, backward=calls * mb)
    plain, undo = counting_plain_calls()
    regimes, undo_regimes = counting_regimes()
    losses, times, positions, profile, step0 = [], [], 0, None, {}
    total = {k: 0 for k in want}
    try:
        for it in range(steps):
            raw = multimodal_train_batch(tcfg, it)
            batch = to_device(raw, device)
            positions += int((row_ids(tcfg, raw) != 0).sum())
            reset_counts()
            plain["plain_calls"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if it == TRAIN_PROFILED_STEP:
                out = []
                profile = device_profile(lambda: out.append(step_fn(state, batch)), 1,
                                         host_ops=False)
                state, metrics = out[0]
            else:
                state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = counts()
            if got != want:
                raise AssertionError(f"{tcfg.arch_id} train step {it}: launches {got}, "
                                     f"expected {want}")
            total = {k: total[k] + got[k] for k in want}
            if it == 0:
                flags = [bool(torch.isfinite(p.grad).all() & (p.grad != 0).any())
                         for p in tree_leaves(state["params"])]
                step0.update(leaves=len(flags), leaves_with_finite_nonzero_grad=sum(flags))
    finally:
        undo()
        undo_regimes()
    peak = torch.cuda.max_memory_allocated()
    del state
    if step0["leaves_with_finite_nonzero_grad"] != step0["leaves"]:
        raise AssertionError(f"{tcfg.arch_id} step 0: only {step0['leaves_with_finite_nonzero_grad']}"
                             f" of {step0['leaves']} parameter leaves have a finite nonzero gradient")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tcfg.arch_id} train losses not finite: {losses}")
    loss0_rel = abs(losses[0] - loss0_fn) / abs(loss0_fn)
    if not loss0_rel <= 1e-3:
        raise AssertionError(f"{tcfg.arch_id} step 0 loss {losses[0]} vs loss_fn {loss0_fn}")
    steady = times[TRAIN_WARMUP:]
    profile["busy_share"] = (profile["device_seconds_per_call"]
                             / profile["profiled_wall_seconds_per_call"])
    res = {"arch": cfg.arch_id, "layers": tcfg.n_layers, "enc_layers": tcfg.n_enc_layers,
           "params": tcfg.param_count(), "optimizer": opt.name, "steps": steps,
           "batch": TRAIN_BATCH, "microbatches": mb, "head_dim": tcfg.head_dim,
           "losses": losses, "step_seconds": times,
           "step_seconds_mean": sum(steady) / len(steady), "step_seconds_min": min(steady),
           "step_seconds_max": max(steady),
           "tokens_per_s": positions * len(steady) / steps / sum(steady),
           "launches_per_step": want, "launches": total, "forward_calls_by_regime": regimes,
           "step0_loss_fn": loss0_fn, "step0_loss_rel": loss0_rel,
           "step0_leaves": step0["leaves"], "max_memory_allocated_bytes": peak,
           "profiled_step": TRAIN_PROFILED_STEP, "profile": profile}
    log("train", json.dumps(res))
    return res


def multimodal_phases(record, device, served):
    """The VLM and encoder-decoder families, into `record["multimodal"]`:
    the kernels in whisper-medium's regimes (`multimodal_kernel_phase`); the
    fp32 parity paths of reduced qwen2-vl-7b (head_dim 128, M-RoPE at its
    real sections) and whisper-medium (head_dim 64) into
    `record["fp32_path"]`; qwen2-vl-7b serving at full depth (28 layers)
    and training cut to VLM_TRAIN_LAYERS; whisper-medium serving and
    training at full depth (24 + 24 layers). `served` gets each serving's
    `keep` (`serve_phase`) under its arch."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import tree_leaves

    mm = record["multimodal"] = {}
    mm["kernel"] = multimodal_kernel_phase(device)
    torch.cuda.empty_cache()
    for arch in ("qwen2-vl-7b", "whisper-medium"):
        cfg = get_arch(arch)
        record["fp32_path"][arch] = fp32_phase(cfg, device, time_kernel=False)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
        torch.cuda.synchronize()
        log(f"{arch}: {cfg.n_layers} layers (+{cfg.n_enc_layers} encoder), d_model "
            f"{cfg.d_model}, {sum(p.numel() for p in tree_leaves(params))} parameters, "
            f"init {time.perf_counter() - t0:.1f} s")
        keep = served.setdefault(arch, {})
        if cfg.enc_dec:
            mm[f"{arch}_serve"] = serve_phase(cfg, params, device, new_tokens=NEW_TOKENS,
                                              check_last=True, max_len=WHISPER_MAX_TARGET,
                                              keep=keep)
        else:
            mm[f"{arch}_serve"] = serve_phase(cfg, params, device, new_tokens=PAPER_NEW_TOKENS,
                                              check_last=True, keep=keep)
        del params
        torch.cuda.empty_cache()
        mm[f"{arch}_train"] = multimodal_train_phase(
            cfg, device, layers=None if cfg.enc_dec else VLM_TRAIN_LAYERS)
        torch.cuda.empty_cache()


def one_rank_mesh(device):
    """A one-rank NCCL process group in this process (on a free localhost
    port) and its (1, 1) `("data", "model")` mesh."""
    import datetime
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    return make_mesh((1, 1), ("data", "model"))


def sharded_parity(policy, device, arch="qwen3-8b", optimizer="adamw", seed=0, layers=None):
    """The fp32 parity model of `arch` (`parity_model`: reduced, at the real
    head width, 2 x PARITY_SEQ; qwen3-8b at head_dim 128, qwen2-vl-7b with
    M-RoPE at its real sections, whisper-medium's encoder, decoder and
    cross-attention at head_dim 64, xlstm-1.3b's mLSTM and sLSTM layers,
    jamba's Mamba, MoE and attention layers) for SHARD_PARITY_STEPS steps of
    `optimizer` (Adafactor with bf16 momentum, as `fp32_phase` runs it)
    unsharded and on the mesh, from the same weight seed and batches: the
    largest difference of a loss (relative) and of a parameter (over its
    leaf's max), whether all are equal bit for bit, and the same kernel
    launches; with `layers`, the parity model cut to that depth."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.packed_flash_attn import BWD_TF32, FWD_TF32
    from repro_torch.parallel.sharding import NULL_POLICY, gather
    from repro_torch.train.optimizer import make_optimizer, tree_leaves
    from repro_torch.train.train_step import build_train_step, init_train_state

    small, _ = parity_model(get_arch(arch))
    if layers is not None:
        small = dataclasses.replace(small, n_layers=layers)
    batches = [parity_model(get_arch(arch), i)[1] for i in range(SHARD_PARITY_STEPS)]
    runs = {}
    for name, pol in (("plain", NULL_POLICY), ("sharded", policy)):
        opt = make_optimizer(optimizer, lr=1e-3, momentum_dtype=(
            torch.bfloat16 if optimizer == "adafactor" else torch.float32))
        state = init_train_state(seed, small, opt, device=device, policy=pol)
        step = build_train_step(small, opt, policy=pol, microbatches=PARITY_MICROBATCHES,
                                compute_dtype=torch.float32)
        reset_counts()
        losses = [float(step(state, to_device(b, device))[1]["loss"]) for b in batches]
        torch.cuda.synchronize()
        runs[name] = (losses, [p.detach() for p in tree_leaves(gather(state["params"]))],
                      {**read_counts(), **read_backward_counts()})
    (l0, p0, c0), (l1, p1, c1) = runs["plain"], runs["sharded"]
    calls = attention_calls(small) * PARITY_MICROBATCHES * SHARD_PARITY_STEPS
    if c1 != c0 or c1[FWD_TF32.source] != 2 * calls or c1[BWD_TF32.source] != calls:
        raise AssertionError(f"{arch}: sharded fp32 steps launch {c1}, the unsharded ones {c0}")
    res = {"arch": arch, "layers": small.n_layers, "enc_layers": small.n_enc_layers,
           "head_dim": small.head_dim, "optimizer": optimizer, "seed": seed,
           "steps": SHARD_PARITY_STEPS, "losses": l1,
           "losses_unsharded": l0,
           "loss_max_rel": max(abs(a - b) / abs(b) for a, b in zip(l1, l0)),
           "param_max_rel": max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                                for a, b in zip(p1, p0)),
           "bit_for_bit": l1 == l0 and all(torch.equal(a, b) for a, b in zip(p1, p0)),
           "launches": c1, "tol": TOL_SHARD}
    if not (res["loss_max_rel"] <= TOL_SHARD and res["param_max_rel"] <= TOL_SHARD):
        raise AssertionError(f"{arch}: sharded fp32 steps vs unsharded: {res}")
    return res


def sharded_train(cfg, policy, device, train, *, layers=TRAIN_LAYERS, steps=SHARD_STEPS,
                  batch_at=None, host_ops=True):
    """Full-width `cfg` cut to `layers` (None: full depth), `steps` steps of
    the unsharded train phase's batches (`batch_at(i)`; by default the
    synthetic token batches of the seed the train phase reads) through
    `build_train_step(..., policy=policy)`: step 0's loss against
    `loss_fn`, every loss against the train phase's (`train`, the unsharded
    run on the same seed and batches), exact launches a step, zero plain
    calls; step seconds, the profile of step TRAIN_PROFILED_STEP (host
    operators traced with `host_ops`, as the unsharded phase traces them)
    and the peak memory. Returns (result, the last step's gradients as
    local tensors): the optimizer state is freed."""
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.train.optimizer import optimizer_for, tree_leaves
    from repro_torch.train.train_step import build_train_step, init_train_state

    tcfg = cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)
    B, mb = TRAIN_BATCH, TRAIN_MICROBATCHES
    if batch_at is None:
        batch_at = SyntheticPackedDataset(tcfg, TRAIN_SEQ, B, seed=0).batch_at
    params = init_params(tcfg, 0, dtype=torch.float32, device=device)
    batch, n = to_device(batch_at(0), device), B // mb
    with torch.no_grad():
        loss0_fn = sum(float(loss_fn(tcfg, params, {k: v[i * n:(i + 1) * n]
                                                    for k, v in batch.items()})[0])
                       for i in range(mb)) / mb
    del params, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = optimizer_for(tcfg, lr=1e-3)
    state = init_train_state(0, tcfg, opt, device=device, policy=policy)
    step = build_train_step(tcfg, opt, policy=policy, microbatches=mb, remat=True)
    want = bf16_launches(tcfg.head_dim, forward=2 * attention_calls(tcfg) * mb,
                         backward=attention_calls(tcfg) * mb)
    plain, undo = counting_plain_calls()
    losses, times, per_step, prof = [], [], [], None
    try:
        for it in range(steps):
            b = to_device(batch_at(it), device)
            reset_counts()
            plain["plain_calls"] = 0
            t0 = time.perf_counter()
            if it == TRAIN_PROFILED_STEP:
                out = []
                prof = device_profile(lambda: out.append(step(state, b)[1]), 1,
                                      host_ops=host_ops)
                metrics = out.pop()
            else:
                metrics = step(state, b)[1]
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
            per_step.append({**read_counts(), **{f"backward[{k}]": v for k, v in
                                                 read_backward_counts().items()},
                             "plain_calls": plain["plain_calls"]})
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    for i, got in enumerate(per_step):
        if got != want:
            raise AssertionError(f"{tcfg.arch_id} sharded train step {i}: launches {got}, "
                                 f"expected {want}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]
    loss0_rel = abs(losses[0] - loss0_fn) / abs(loss0_fn)
    if not (loss0_rel <= 1e-3 and max(rel) <= 1e-3 and all(map(math.isfinite, losses))):
        raise AssertionError(f"{tcfg.arch_id} sharded losses {losses} vs the train phase's "
                             f"{train['losses'][:steps]}, step 0 vs loss_fn {loss0_fn}")
    steady = [t for i, t in enumerate(times) if i >= TRAIN_WARMUP and i != TRAIN_PROFILED_STEP]
    prof["busy_share"] = prof["device_seconds_per_call"] / prof["profiled_wall_seconds_per_call"]
    tp = train["profile"]
    res = {"arch": cfg.arch_id, "layers": tcfg.n_layers, "enc_layers": tcfg.n_enc_layers,
           "steps": steps, "losses": losses,
           "losses_train_phase": train["losses"][:steps], "loss_max_rel": max(rel),
           "step0_loss_fn": loss0_fn, "step0_loss_rel": loss0_rel, "step_seconds": times,
           "step_seconds_mean": sum(steady) / len(steady),
           "train_phase_step_seconds_mean": train["step_seconds_mean"],
           "launches_per_step": want, "profile": prof,
           "busy_share": prof["busy_share"], "train_phase_busy_share": tp and tp["busy_share"],
           "max_memory_allocated_bytes": peak,
           "train_phase_max_memory_allocated_bytes": train["max_memory_allocated_bytes"]}
    grads = [p.grad.to_local() for p in tree_leaves(state["params"])]
    del state, opt, step
    torch.cuda.empty_cache()
    return res, grads


def sharded_serve(cfg, policy, device, ref, *, profile_decode=False):
    """`cfg` at full depth served on the mesh as `serve_phase` serves it
    unsharded: the same `serve_prompt` prompts and seed-0 bf16 weights
    (placed by the sharding rules), prefill through
    `build_prefill_step(..., policy=)`, its caches extended to the
    unsharded run's slots and placed by `launch.specs.place_cache` (an
    encoder-decoder's constant cross caches too), then SHARD_NEW_TOKENS
    greedy steps through `build_serve_step(..., policy=)`. Held to the
    unsharded run (`ref`, `serve_phase`'s keep): every token equal, the
    prefill's last logits within TOL_PREFILL_REL and each step's within
    TOL_DECODE_REL; prefill launches the bf16 kernel once an attention call
    (through `local_map`; none in a model without attention), decode none,
    no plain call. Records prefill seconds, decode ms a step (step 0,
    DTensor's first dispatch of each op, apart), the placements of the
    first layer's cache and the peak memory; with `profile_decode`, the
    busy share of 2 decode steps profiled on the device alone."""
    from repro_torch.kernels.packed_flash_attn import kernel_for
    from repro_torch.launch.specs import place_cache
    from repro_torch.models.model import extend_cache, init_params, param_axes
    from repro_torch.parallel.sharding import gather
    from repro_torch.train.train_step import build_prefill_step, build_serve_step

    n = SHARD_NEW_TOKENS
    params = policy.distribute(init_params(cfg, seed=0, dtype=torch.bfloat16, device=device),
                               param_axes(cfg))
    batch, extra = serve_prompt(cfg, device)
    P = row_ids(cfg, batch).shape[1]
    prefill_step, serve_step = build_prefill_step(cfg, policy=policy), build_serve_step(
        cfg, policy=policy)
    calls = attention_calls(cfg)
    kern = kernel_for(torch.bfloat16, cfg.head_dim) if calls else None
    plain, undo = counting_plain_calls()
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.no_grad():
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, caches = prefill_step(params, policy.distribute_batch(batch))
            last = gather(last)[:, -1]
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            prefill_launches = read_counts()
            cache = place_cache(policy, extend_cache(cfg, gather(caches), ref["max_len"]))
            del caches
            tok = last.argmax(-1).to(torch.int32)
            generated, logits, marks = [tok], [], []
            reset_counts()
            for i in range(n):
                if i < 2:  # step 0 timed alone, then the rest
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())
                lengths = torch.full((SERVE_B,), P + i, dtype=torch.int32, device=device)
                nxt, step_logits, cache = serve_step(params, cache, policy.distribute_batch(
                    {"tokens": tok[:, None], "lengths": lengths, **extra}))
                tok = gather(nxt)
                logits.append(gather(step_logits)[:, 0])
                generated.append(tok)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            decode_launches = read_counts()
            slots = next((c["mixer"]["k"].shape[1] for c in cache if "k" in c["mixer"]), None)
            placed = {k: [str(p) for p in v.placements] for k, v in (
                *cache[0]["mixer"].items(), *((("k_const", cache[0]["cross"]["k_const"]),)
                                              if cfg.enc_dec else ()))}
            prof = None
            if profile_decode:  # the last step again, on the device alone
                step_batch = policy.distribute_batch({"tokens": tok[:, None],
                                                      "lengths": lengths + 1, **extra})
                prof = device_profile(lambda: serve_step(params, cache, step_batch), 2,
                                      host_ops=False)
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated()
    del params, cache
    tokens = torch.stack(generated, 1).cpu()
    e_prefill = rel_err(last.cpu(), ref["prefill"])
    e_decode = [rel_err(a.cpu(), b) for a, b in zip(logits, ref["decode"])]
    res = {"arch": cfg.arch_id, "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "prompt": P, "new_tokens": n, "cache_slots": slots, "cache_placements": placed,
           "tokens_equal": torch.equal(tokens, ref["tokens"][:, :n + 1]),
           "prefill_rel_err": e_prefill, "decode_rel_err_max": max(e_decode),
           "prefill_seconds": t_prefill, "decode_ms_first_step": (marks[1] - marks[0]) * 1e3,
           "decode_ms_per_token": (marks[2] - marks[1]) / (n - 1) * 1e3,
           "prefill_launches": prefill_launches, "decode_launches": decode_launches,
           "plain_calls": plain["plain_calls"], "max_memory_allocated_bytes": peak,
           "decode_profile": prof}
    if prof is not None:
        prof["busy_share"] = prof["device_seconds_per_call"] / (res["decode_ms_per_token"] / 1e3)
    if not ((kern is None or prefill_launches[kern.source] == calls)
            and sum(prefill_launches.values()) == calls
            and sum(decode_launches.values()) == 0 and plain["plain_calls"] == 0):
        raise AssertionError(f"{cfg.arch_id} sharded serving launches {res}, expected {calls} "
                             f"of {kern and kern.source} in prefill only")
    if not (res["tokens_equal"] and e_prefill <= TOL_PREFILL_REL
            and max(e_decode) <= TOL_DECODE_REL):
        raise AssertionError(f"{cfg.arch_id} sharded serving vs unsharded: {res}; tokens "
                             f"{tokens.tolist()} vs {ref['tokens'][:, :n + 1].tolist()}")
    torch.cuda.empty_cache()
    return res


def sharded_recurrent_train(cfg, policy, device, loops):
    """xlstm-1.3b at full width cut to its first period (7 mLSTM layers, an
    sLSTM), SHARD_RECURRENT_STEPS AdamW steps (fp32 masters, bf16 compute,
    remat) of one 1 x SHARD_XLSTM_SEQ micro-batch each, unsharded and on the
    mesh from the same seed and batches: every loss and the last step's
    gradients equal (TOL_SHARD of each leaf's max), exact launches (none:
    no attention) and no plain call. Records each run's step seconds (the
    last step's: the first warms up), peak memory, and a busy share whose
    device time is composed from `loops` (`loop_profile`'s layers at 1 x
    TRAIN_SEQ / XLSTM_TRAIN_SCALE, forward and train, the LM head, loss and
    AdamW left out): a profile of the step's ~30 k launches would take
    longer than the steps."""
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.parallel.sharding import NULL_POLICY
    from repro_torch.train.optimizer import optimizer_for, tree_leaves
    from repro_torch.train.train_step import build_train_step, init_train_state

    tcfg = dataclasses.replace(cfg, n_layers=len(cfg.period))
    if TRAIN_SEQ // XLSTM_TRAIN_SCALE != SHARD_XLSTM_SEQ:
        raise AssertionError("the layers' profiles are not at the cut's length")
    data = SyntheticPackedDataset(tcfg, SHARD_XLSTM_SEQ, 1, seed=0)
    runs = {}
    plain, undo = counting_plain_calls()
    try:
        for name, pol in (("unsharded", NULL_POLICY), ("sharded", policy)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            opt = optimizer_for(tcfg, lr=1e-3)
            state = init_train_state(0, tcfg, opt, device=device, policy=pol)
            step = build_train_step(tcfg, opt, policy=pol, microbatches=1, remat=True)
            losses, times = [], []
            reset_counts()
            for it in range(SHARD_RECURRENT_STEPS):
                b = to_device(data.batch_at(it), device)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(state, b)[1]["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            grads = [x.grad.to_local() if pol is policy else x.grad
                     for x in tree_leaves(state["params"])]
            runs[name] = {"losses": losses, "step_seconds": times,
                          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                          "launches": sum({**read_counts(), **read_backward_counts()}.values()),
                          "grads": [g.detach().clone() for g in grads]}
            del state, opt, step, grads
    finally:
        undo()
    u, sh = runs["unsharded"], runs["sharded"]
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(sh.pop("grads"), u.pop("grads"), strict=True))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sh["losses"], u["losses"]))
    for r in (u, sh):  # the layers' profiles are scaled to TRAIN_SEQ: back to the cut's
        r["step_seconds_last"] = r["step_seconds"][-1]
        prof = composed_profile(tcfg, loops, ("layer_forward", "layer_train"), 1.0)
        for key in ("device_seconds_per_call", "kernels_per_call"):
            prof[key] /= XLSTM_TRAIN_SCALE
        prof["busy_share"] = prof["device_seconds_per_call"] / r["step_seconds_last"]
        r["profile"], r["busy_share"] = prof, prof["busy_share"]
    res = {"arch": cfg.arch_id, "layers": tcfg.n_layers, "tokens": SHARD_XLSTM_SEQ,
           "steps": SHARD_RECURRENT_STEPS, "unsharded": u, "sharded": sh,
           "loss_max_rel": loss_rel, "grad_max_rel": grad_rel,
           "bit_for_bit": loss_rel == 0 and grad_rel == 0, "plain_calls": plain["plain_calls"],
           "sharded_over_unsharded": sh["step_seconds_last"] / u["step_seconds_last"]}
    if not (loss_rel <= TOL_SHARD and grad_rel <= TOL_SHARD and u["launches"] == sh["launches"]
            == 0 and plain["plain_calls"] == 0 and all(map(math.isfinite, sh["losses"]))):
        raise AssertionError(f"{cfg.arch_id} sharded train vs unsharded: {res}")
    torch.cuda.empty_cache()
    return res


def sharded_mamba_layer(cfg, policy, device):
    """jamba's period position 1 (Mamba + dense FFN) as `mamba_layer_phase`
    builds it (the same seed, fp32 masters, bf16 compute, 1 x TRAIN_SEQ
    packed documents): the forward and the backward of sum(out * r)
    unsharded and on the mesh (parameters placed by their logical axes, the
    input and the ids as a batch), each run twice (the first warms up):
    output and every gradient equal (TOL_SHARD of each leaf's max),
    CUDA-event milliseconds of both beside each other."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.model import apply_layer, init_layer, layer_axes
    from repro_torch.parallel.sharding import NULL_POLICY
    from repro_torch.train.optimizer import tree_leaves

    spec = cfg.period[1]
    g = torch.Generator(device=device)
    g.manual_seed(6)
    p = init_layer(g, cfg, spec, dtype=torch.float32, device=device)
    md = packed_md(cfg, 1, TRAIN_SEQ, device)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=g, device=device)
    r = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=g, device=device)

    def run(pol):
        pp = pol.distribute(p, layer_axes(cfg, spec))
        leaves = tree_leaves(pp)
        for leaf in leaves:
            leaf.requires_grad_(True)
        mdp = {**md, **pol.distribute_batch({k: md[k] for k in ("segment_ids", "positions",
                                                                "abs_positions")})}
        xi, ri = (pol.distribute_batch({"x": t})["x"] for t in (x.to(torch.bfloat16), r))
        out = ms = None
        for _ in range(2):
            xi = xi.detach().requires_grad_(True)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with implicit_replication() if pol.mesh is not None else contextlib.nullcontext():
                events[0].record()
                out, _ = apply_layer(cfg, spec, pp, xi, mdp, policy=pol)
                events[1].record()
                grads = torch.autograd.grad((out.float() * ri).sum(), [xi] + leaves)
                events[2].record()
            torch.cuda.synchronize()
            ms = (events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2]))

        def local(t):
            return (t.to_local() if isinstance(t, DTensor) else t).detach()
        return local(out), [local(gr) for gr in grads], ms
    (o0, g0, ms0), (o1, g1, ms1) = run(NULL_POLICY), run(policy)
    errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
            for a, b in zip([o1] + g1, [o0] + g0, strict=True)]
    res = {"arch": cfg.arch_id, "period_position": 1, "spec": f"{spec.mixer}+{spec.ffn}",
           "tokens": TRAIN_SEQ, "output_and_grads_max_rel": max(errs),
           "bit_for_bit": torch.equal(o1, o0) and all(torch.equal(a, b) for a, b in zip(g1, g0)),
           "forward_event_ms": {"unsharded": ms0[0], "sharded": ms1[0]},
           "backward_event_ms": {"unsharded": ms0[1], "sharded": ms1[1]}, "tol": TOL_SHARD}
    if not max(errs) <= TOL_SHARD:
        raise AssertionError(f"{cfg.arch_id} sharded Mamba layer vs unsharded: {res}")
    torch.cuda.empty_cache()
    return res


def sharded_layer_launches(cfg, policy, device, *, S=128):
    """Kernels one layer of each recurrent mixer of `cfg` launches (its
    first spec without MoE; bf16 weights, forward in inference on 1 x S
    packed documents), unsharded and on the mesh (the device profiled
    alone), and those of its scan alone (`SCANS`, called on the inputs the
    layer handed it): the loops run on local shards, so both launch the
    same kernels."""
    import importlib

    from repro_torch.models.model import apply_layer, init_layer, layer_axes
    from repro_torch.parallel.sharding import NULL_POLICY

    g = torch.Generator(device=device)
    g.manual_seed(3)
    md = packed_md(cfg, 1, S, device)
    out = {}
    for kind in [m for m in RECURRENT if any(sp.mixer == m for sp in cfg.period)]:
        spec = next(sp for sp in sorted(cfg.period, key=lambda sp: sp.ffn == "moe")
                    if sp.mixer == kind)
        module, name = SCANS[kind]
        mod = importlib.import_module(module)
        scan, calls = getattr(mod, name), []

        def counting(*args):
            calls.append(1)
            return scan(*args)
        x = torch.randn((1, S, cfg.d_model), generator=g, device=device).to(torch.bfloat16)
        row = {"spec": f"{spec.mixer}+{spec.ffn}", "positions": S}
        with torch.no_grad():
            p = init_layer(g, cfg, spec, dtype=torch.bfloat16, device=device)
            for tag, pol in (("unsharded", NULL_POLICY), ("sharded", policy)):
                pp = pol.distribute(p, layer_axes(cfg, spec))
                mdp = {**md, **pol.distribute_batch({k: md[k] for k in (
                    "segment_ids", "positions", "abs_positions")})}
                xp = pol.distribute_batch({"x": x})["x"]

                def layer():
                    return apply_layer(cfg, spec, pp, xp, mdp, policy=pol)
                setattr(mod, name, counting)
                try:
                    layer()  # warm-up
                    row[f"{tag}_scan_calls"] = len(calls)
                    calls.clear()
                finally:
                    setattr(mod, name, scan)
                row[tag] = device_profile(layer, 1, host_ops=False)["kernels_per_call"]
        row["equal"] = row["unsharded"] == row["sharded"]
        out[kind] = row
        del p
    torch.cuda.empty_cache()
    log(f"sharding: {cfg.arch_id} launches a layer", json.dumps(out))
    return out


def compression_check(grads, device):
    """`compress_tree` with error feedback over `grads` (every leaf of a
    full-width step's fp32 gradients), from zero residuals, then again from
    its own residuals, timed: seconds and GB/s of the 16 bytes an element it
    must move (the gradient and residual read, the dequantized gradient and
    the new residual written) beside that traffic's HBM bound; one leaf's
    codes and scales held equal to the same function on the CPU."""
    from repro_torch.train.compression import Int8Compressor, compress_tree, init_feedback

    torch.cuda.empty_cache()
    comp = Int8Compressor(block=COMPRESS_BLOCK)
    n = sum(g.numel() for g in grads)
    reckoned = 4 * 4 * n  # the gradients, residuals, dequantized and new residuals, fp32
    free, total = torch.cuda.mem_get_info()
    if reckoned > free:
        raise AssertionError(f"compression: {reckoned} bytes reckoned, {free} free")
    torch.cuda.reset_peak_memory_stats()
    res = init_feedback(grads)
    deq, res = compress_tree(comp, grads, res)
    del deq
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deq, res = compress_tree(comp, grads, res)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not all(bool(torch.isfinite(d).all()) for d in deq):
        raise AssertionError("compression: a dequantized gradient is not finite")
    leaf = max(grads, key=lambda g: g.numel() if g.numel() < 2 ** 25 else 0)  # a layer's wq
    q, s, _ = comp.compress(leaf)
    q_cpu, s_cpu, _ = comp.compress(leaf.cpu())
    equal = torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)
    if not equal:
        raise AssertionError("compression: the card's codes or scales differ from the CPU's")
    moved = 16 * n
    out = {"elements": n, "block": COMPRESS_BLOCK, "seconds": seconds,
           "gb_per_s": moved / seconds / 1e9, "bound_ms": moved / PEAK_BYTES * 1e3,
           "bound_share": moved / PEAK_BYTES / seconds,
           "ratio": comp.ratio(grads[0]), "reckoned_bytes": reckoned,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "cpu_equal_leaf_shape": list(leaf.shape), "cpu_equal": equal}
    del deq, res
    torch.cuda.empty_cache()
    return out


def sharded_moe(mesh, device):
    """qwen3-moe-30b-a3b cut to MOE_TRAIN_LAYERS layers: one train step
    unsharded, one through the MoE layer's EP path and one through its TP
    path on the mesh, from the same seed and batch: each loss held to the
    unsharded one (1e-3) and each token's routes in every MoE call equal.
    Without remat, so that every call records its routes (a recompute stops
    once the tensors its backward needs are back, which may come before a
    layer records them)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.parallel.sharding import NULL_POLICY, policy_for_mesh
    from repro_torch.train.optimizer import optimizer_for
    from repro_torch.train.train_step import build_train_step, init_train_state

    mcfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b"), n_layers=MOE_TRAIN_LAYERS)
    batch = to_device(SyntheticPackedDataset(mcfg, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch_at(0),
                      device)
    routes, losses, seconds = {}, {}, {}
    for name, pol in (("plain", NULL_POLICY), ("ep", policy_for_mesh(mesh, expert_parallel=True)),
                      ("tp", policy_for_mesh(mesh))):
        opt = optimizer_for(mcfg, lr=1e-3)
        state = init_train_state(0, mcfg, opt, device=device, policy=pol)
        step = build_train_step(mcfg, opt, policy=pol, microbatches=TRAIN_MICROBATCHES,
                                remat=False)
        t0 = time.perf_counter()
        with recording_routes(routes, name):
            losses[name] = float(step(state, batch)[1]["loss"])
        seconds[name] = time.perf_counter() - t0
        del state, opt, step
        torch.cuda.empty_cache()
    out = {"layers": mcfg.n_layers, "losses": losses, "step_seconds": seconds}
    for name in ("ep", "tp"):
        rel = abs(losses[name] - losses["plain"]) / abs(losses["plain"])
        same = len(routes[name]) == len(routes["plain"]) and all(
            torch.equal(a[k], b[k]) for a, b in zip(routes[name], routes["plain"])
            for k in ("experts", "kept"))
        out[f"{name}_loss_rel"], out[f"{name}_routes_equal"] = rel, same
        if not (rel <= 1e-3 and same):
            raise AssertionError(f"MoE {name} path: loss {losses[name]} vs {losses['plain']}, "
                                 f"routes equal {same}")
    out["moe_calls"] = len(routes["plain"])
    if out["moe_calls"] != TRAIN_MICROBATCHES * MOE_TRAIN_LAYERS:
        raise AssertionError(f"MoE steps recorded {out['moe_calls']} calls' routes")
    return out


def recurrent_sharding(record, rec, policy, device, served):
    """Phase 14's recurrent families on the mesh, into `rec`: the fp32 parity
    of reduced xlstm-1.3b (AdamW) and reduced jamba-1.5-large-398b
    (Adafactor, weight seed 1, as phase 13 runs them), each cut to one
    period; serving of xlstm-1.3b
    at full depth and jamba cut to JAMBA_LAYERS held to phase 13's
    (`served`), with decode's busy share; the xlstm-1.3b cut's train steps
    on the mesh and unsharded (`sharded_recurrent_train`, its device time
    composed from phase 13's layers at 1 x 1024); jamba's Mamba layer
    forward and backward (`sharded_mamba_layer`); and each mixer's kernels
    a layer on the mesh and unsharded (`sharded_layer_launches`)."""
    from repro_torch.configs import get_arch

    rr = record["recurrent"]
    xcfg, jcfg = get_arch("xlstm-1.3b"), get_arch("jamba-1.5-large-398b")
    jcut = dataclasses.replace(jcfg, n_layers=JAMBA_LAYERS, period=jcfg.period[:JAMBA_LAYERS])
    t0 = time.perf_counter()

    def mark(part):
        rec["seconds_by_recurrent_part"][part] = time.perf_counter() - t0
        log(f"sharding: {rec['seconds_by_recurrent_part'][part]:.1f} s into the recurrent "
            f"parts after {part}")
    rec["seconds_by_recurrent_part"] = {}
    # each parity model cut to one period (phase 13's holds two): every mixer
    # once, the sLSTM loops half as many
    for arch, kw in (("xlstm-1.3b", {}), ("jamba-1.5-large-398b",
                                          {"optimizer": "adafactor", "seed": 1})):
        rec[f"{arch}_fp32_parity"] = sharded_parity(policy, device, arch, **kw,
                                                    layers=len(get_arch(arch).period))
        log(f"sharding: {arch} fp32 parity", json.dumps(rec[f"{arch}_fp32_parity"]))
    mark("fp32 parity")
    for cfg in (xcfg, jcut):
        res = rec[f"{cfg.arch_id}_serve"] = sharded_serve(cfg, policy, device,
                                                          served[cfg.arch_id],
                                                          profile_decode=True)
        ref = rr[f"{cfg.arch_id}_serve"]
        res["unsharded"] = {"prefill_seconds": ref["prefill_seconds"],
                            "decode_ms_per_token": ref["decode_ms_per_token"],
                            "decode_busy_share": ref["decode_profile"]["busy_share"],
                            "max_memory_allocated_bytes": ref["max_memory_allocated_bytes"]}
        res["launches_a_layer"] = sharded_layer_launches(cfg, policy, device)
        log(f"sharding: {cfg.arch_id} serve", json.dumps(res))
        mark(f"{cfg.arch_id} serve")
    rec[f"{xcfg.arch_id}_train"] = sharded_recurrent_train(
        xcfg, policy, device, rr[f"{xcfg.arch_id}_train"]["loops"]["by_mixer"])
    log(f"sharding: {xcfg.arch_id} train", json.dumps(rec[f"{xcfg.arch_id}_train"]))
    mark(f"{xcfg.arch_id} train")
    rec["mamba_layer"] = sharded_mamba_layer(jcfg, policy, device)
    rec["mamba_layer"]["unsharded_phase_13"] = {
        k: rr["mamba_layer"][k] for k in ("forward_event_ms", "backward_event_ms")}
    log("sharding: mamba layer", json.dumps(rec["mamba_layer"]))
    mark("mamba layer")


def stage_mesh_pipeline(record, device):
    """Phase 14's ResiHP runtime on stage meshes: `pipeline_phase` under the
    one-rank process group, so that the engine runs each stage as an SPMD
    program on its own (data, model) mesh (DTensor leaves of the master,
    the stage policy, boundary tensors handed over and the DP reduce as one
    all-reduce of a flat buffer); every stage is the (1, 1) mesh over rank
    0. Phase 8's model, plan and fail-stop for STAGE_MESH_SPEC's 6 steps:
    the losses equal phase 8's first 6 bit for bit, each step's launches
    phase 8's; step seconds, busy share and peak memory beside phase 8's;
    each step's hand-off bytes beside Fig. 7's `p2p_cost_bytes`: every
    stage's rank holds each boundary tensor, so none is sent."""
    from repro_torch.configs import get_arch

    res = pipeline_phase(get_arch("qwen3-8b"), device, STAGE_MESH_SPEC)
    ref = record["pipeline"]
    n = STAGE_MESH_SPEC["steps"]
    if not res["spmd"] or any(m["shape"] != [1, 1] or m["ranks"] != [0]
                              for m in res["stage_meshes"].values()):
        raise AssertionError(f"stage meshes: {res['stage_meshes']}")
    if res["losses"] != ref["losses"][:n]:
        raise AssertionError(f"stage-mesh losses {res['losses']} against phase 8's "
                             f"{ref['losses'][:n]}")
    if res["launches_by_step"] != ref["launches_by_step"][:n]:
        raise AssertionError(f"stage-mesh launches {res['launches_by_step']} against phase 8's "
                             f"{ref['launches_by_step'][:n]}")
    sent = [h["sent_bytes"] for h in res["hand_off_bytes"]]
    log("sharding: stage-mesh hand-offs by step (count, bytes sent, p2p_cost_bytes)",
        json.dumps([[h["hand_offs"], h["sent_bytes"], h["p2p_cost_bytes"]]
                    for h in res["hand_off_bytes"]]))
    if len(sent) != n or any(sent):
        raise AssertionError(f"stage-mesh hand-offs on one rank sent bytes: {sent}")
    busy = res["profile"].get("busy_share")
    res["against_unmeshed"] = {
        "losses_equal": True, "launches_equal": True,
        "step_seconds_mean": [res["step_seconds_mean"], ref["step_seconds_mean"]],
        "busy_share": [busy, ref["profile"].get("busy_share")],
        "max_memory_allocated_gb": [res["max_memory_allocated_bytes"] / 1e9,
                                    ref["max_memory_allocated_bytes"] / 1e9]}
    log("sharding: stage-mesh pipeline against phase 8 (meshed, unmeshed)",
        json.dumps(res["against_unmeshed"]))
    return res


def sharding_phase(record, device, served):
    """Phase 14: the sharded step and serving on a (1, 1) mesh of a one-rank
    NCCL group, and the MoE layer on a (1, 1, 1) (pod, data, model) mesh of
    the same group (each part in the module's docstring); `served` holds
    the unsharded serve phases' tokens and logits by arch. Destroys the
    group after."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import policy_for_mesh

    t0 = time.perf_counter()
    mesh = one_rank_mesh(device)
    mm = record["multimodal"]

    def mark(part):
        rec["seconds_by_part"][part] = time.perf_counter() - t0
        log(f"sharding: {rec['seconds_by_part'][part]:.1f} s after {part}")
    try:
        policy = policy_for_mesh(mesh)
        rec = record["sharding"] = {"mesh": {"shape": list(mesh.shape),
                                             "axes": list(mesh.mesh_dim_names)},
                                    "seconds_by_part": {}}
        torch.cuda.empty_cache()
        rec["pipeline"] = stage_mesh_pipeline(record, device)
        torch.cuda.empty_cache()
        mark("stage-mesh pipeline")
        rec["fp32_parity"] = sharded_parity(policy, device)
        log("sharding: fp32 parity", json.dumps(rec["fp32_parity"]))
        rec["train"], grads = sharded_train(get_arch("qwen3-8b"), policy, device, record["train"])
        log("sharding: train", json.dumps({k: v for k, v in rec["train"].items()
                                           if k != "profile"}))
        rec["compression"] = compression_check(grads, device)
        del grads
        log("sharding: compression", json.dumps(rec["compression"]))
        mark("qwen3-8b")
        for arch in SHARD_FAMILIES:
            cfg = get_arch(arch)
            rec[f"{arch}_fp32_parity"] = sharded_parity(policy, device, arch)
            log(f"sharding: {arch} fp32 parity", json.dumps(rec[f"{arch}_fp32_parity"]))
            rec[f"{arch}_train"], _ = sharded_train(
                cfg, policy, device, mm[f"{arch}_train"], steps=SHARD_FAMILY_STEPS,
                layers=None if cfg.enc_dec else VLM_TRAIN_LAYERS,
                batch_at=functools.partial(multimodal_train_batch, cfg), host_ops=False)
            log(f"sharding: {arch} train", json.dumps({k: v for k, v in
                                                       rec[f"{arch}_train"].items()
                                                       if k != "profile"}))
            mark(f"{arch} parity and train")
        for arch in ("qwen3-8b",) + SHARD_FAMILIES:
            rec[f"{arch}_serve"] = sharded_serve(get_arch(arch), policy, device, served[arch])
            rec[f"{arch}_serve"]["unsharded_decode_ms_per_token"] = (
                record["serve"] if arch == "qwen3-8b" else mm[f"{arch}_serve"])[
                    "decode_ms_per_token"]
            log(f"sharding: {arch} serve", json.dumps(rec[f"{arch}_serve"]))
        mark("serving")
        recurrent_sharding(record, rec, policy, device, served)
        mark("recurrent")
        pod = make_mesh((1, 1, 1), ("pod", "data", "model"))
        rec["moe"] = sharded_moe(pod, device)
        rec["moe"]["mesh"] = {"shape": list(pod.shape), "axes": list(pod.mesh_dim_names)}
        log("sharding: moe", json.dumps(rec["moe"]))
        mark("moe")
    finally:
        dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0


def meta_like(batch):
    """A dict of arrays or tensors as meta tensors of the same shapes and dtypes."""
    return {k: torch.empty(tuple(v.shape), dtype=torch.as_tensor(v.flatten()[:0]).dtype,
                           device="meta") for k, v in batch.items()}


def tree_bytes(tree):
    from repro_torch.train.optimizer import tree_leaves

    return sum(nbytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def meta_train_count(cfg, opt, batch, microbatches):
    """One train step of `cfg` (unsharded, remat) on the meta device under
    the op counter -> (counter, bytes of the state and batch)."""
    from repro_torch.roofline.counter import OpCounter
    from repro_torch.train.train_step import build_train_step, init_train_state

    state = init_train_state(0, cfg, opt, device="meta")
    state["step"] = torch.zeros((), dtype=torch.int32)  # the optimizer reads it on the host
    args = tree_bytes(state) + tree_bytes(batch)
    with OpCounter() as c:
        build_train_step(cfg, opt, microbatches=microbatches)(state, batch)
    return c, args


def counted_row(c, arg_bytes, seconds, peak_bytes):
    """A counted step beside its measured time and peak memory: the H100
    bound (the larger of the counted FLOPs over the bf16 peak and the
    counted bytes over the HBM rate), its share of the measured seconds,
    and the predicted peak (arguments + the counter's peak of the bytes the
    step's ops held) against `max_memory_allocated`."""
    t_ops, t_bytes = c.flops / PEAK_BF16_FLOPS, c.hbm_bytes / PEAK_BYTES
    return {"flops": c.flops, "matmul_flops": c.matmul_flops,
            "attention_flops": c.attention_flops, "hbm_bytes": c.hbm_bytes, "ops": sum(
                c.calls.values()),
            "bound_s": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "measured_s": seconds, "bound_share": max(t_ops, t_bytes) / seconds,
            "predicted_peak_bytes": arg_bytes + c.peak_bytes,
            "argument_bytes": arg_bytes, "temp_bytes": c.peak_bytes,
            "max_memory_allocated_bytes": peak_bytes,
            "predicted_over_measured_peak": (arg_bytes + c.peak_bytes) / peak_bytes}


def op_dispatch_cost(device, calls=400, rounds=5):
    """Host microseconds a call of the forward kernel through its PyTorch op
    (`torch.ops.repro_torch.packed_attn_fwd`) and through the wrapper alone,
    in turns, at a launch-bound shape (1 x 128, 4 heads, head_dim 64, bf16):
    the least over `rounds` rounds of `calls` calls each, then a synchronize."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.packed_flash_attn import packed_flash_attention

    g = torch.Generator(device=device).manual_seed(5)
    q, k, v = (torch.randn((1, 128, 4, 64), generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    seg = torch.ones((1, 128), dtype=torch.int32, device=device)
    pos = torch.arange(128, dtype=torch.int32, device=device)[None]
    ways = {"op": lambda: ops._FWD(q, k, v, seg, seg, pos, pos, True, None, None, False),
            "wrapper": lambda: packed_flash_attention(q, k, v, seg, seg, pos, pos)}
    best = {name: math.inf for name in ways}
    for _ in range(rounds):
        for name, call in ways.items():
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            best[name] = min(best[name], (time.perf_counter() - t0) / calls * 1e6)
    return {"op_us": best["op"], "wrapper_us": best["wrapper"],
            "op_extra_us": best["op"] - best["wrapper"]}


def roofline_phase(record, device):
    """Phase 15: the op counter and the dry-run on the card's machine.

    Counts on the meta device the steps the script timed (qwen3-8b's
    TRAIN_LAYERS-layer train step, its SERVE_B x PROMPT prefill, whisper's
    train step) and sets each beside its measured seconds and peak memory;
    counts one real qwen3-8b train step on the card under the counter, whose
    matmul FLOPs must equal the meta count's and whose attention FLOPs must
    equal `attention_bound`'s visible pairs for that batch (every layer of a
    micro-batch: the forward twice, forward and remat, 2 products, and the
    backward once, 5), with the train phase's launches; times a kernel call
    through its op against the wrapper alone (`op_dispatch_cost`); counts
    xlstm-1.3b's one-period step on meta and on the card (`recurrent_count`);
    and runs the dry-run of qwen3-8b decode_32k and xlstm-1.3b long_500k on
    the (16, 16) fake-group mesh in subprocesses, whose status must be `ok`."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.kernels.ref import attention_mask
    from repro_torch.models.model import init_params
    from repro_torch.roofline.counter import OpCounter
    from repro_torch.train.optimizer import optimizer_for
    from repro_torch.train.train_step import build_prefill_step, build_train_step, init_train_state

    t0 = time.perf_counter()
    res = record["roofline"] = {"card": record["card"]}
    cfg = get_arch("qwen3-8b")
    tcfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    opt = optimizer_for(tcfg, lr=1e-3)  # the spmd driver's
    raw = SyntheticPackedDataset(tcfg, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch_at(0)
    train, meta = record["train"], {}
    meta["train"], args = meta_train_count(tcfg, opt, meta_like(raw), TRAIN_MICROBATCHES)
    res["qwen3-8b_train"] = counted_row(meta["train"], args, train["step_seconds_mean"],
                                        train["max_memory_allocated_bytes"])
    prompt, _ = serve_prompt(cfg, "meta")
    params = init_params(cfg, dtype=torch.bfloat16, device="meta")
    with OpCounter() as c, torch.no_grad():
        build_prefill_step(cfg)(params, prompt)
    serve = record["serve"]
    res["qwen3-8b_prefill"] = counted_row(c, tree_bytes(params) + tree_bytes(prompt),
                                          serve["prefill_seconds"],
                                          serve["max_memory_allocated_bytes"])
    del params
    wcfg = get_arch("whisper-medium")
    wtrain = record["multimodal"]["whisper-medium_train"]
    c, args = meta_train_count(wcfg, optimizer_for(wcfg, lr=1e-3),
                               meta_like(multimodal_train_batch(wcfg, 0)), TRAIN_MICROBATCHES)
    res["whisper-medium_train"] = counted_row(c, args, wtrain["step_seconds_mean"],
                                              wtrain["max_memory_allocated_bytes"])
    for name in ("qwen3-8b_train", "qwen3-8b_prefill", "whisper-medium_train"):
        log(f"roofline: {name} counted on meta", json.dumps(res[name]))

    # one real step under the counter, against the meta count and the pairs
    state = init_train_state(0, tcfg, opt, device=device)
    batch = to_device(raw, device)
    step = build_train_step(tcfg, opt, microbatches=TRAIN_MICROBATCHES)
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    with OpCounter() as real:
        step(state, batch)
        torch.cuda.synchronize()
    counted_s = time.perf_counter() - t1
    launches = {**read_counts(), **{f"backward[{k}]": v
                                    for k, v in read_backward_counts().items()}}
    del state
    torch.cuda.empty_cache()
    want_launches = {k: v for k, v in train["launches_per_step"].items() if k != "plain_calls"}
    n, calls = TRAIN_BATCH // TRAIN_MICROBATCHES, attention_calls(tcfg)
    q_like = torch.empty((n, TRAIN_SEQ, tcfg.n_heads, tcfg.head_dim), dtype=torch.bfloat16,
                         device="meta")
    pairs_flops = 0.0
    for i in range(TRAIN_MICROBATCHES):
        seg = batch["segment_ids"][i * n:(i + 1) * n]
        pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=device).repeat(n, 1)
        mask = attention_mask(seg, seg, pos, pos, causal=True, window=None)
        pairs_flops += calls * (2 * attention_bound(q_like, mask, 2, 0)[2]
                                + attention_bound(q_like, mask, 5, 0)[2])
    res["qwen3-8b_train_counted_on_card"] = {
        "flops": real.flops, "matmul_flops": real.matmul_flops,
        "attention_flops": real.attention_flops, "hbm_bytes": real.hbm_bytes,
        "meta_matmul_flops": meta["train"].matmul_flops,
        "meta_attention_flops": meta["train"].attention_flops,
        "attention_bound_flops": pairs_flops, "launches": launches,
        "counted_step_seconds": counted_s}
    log("roofline: qwen3-8b train counted on the card",
        json.dumps(res["qwen3-8b_train_counted_on_card"]))
    if real.matmul_flops != meta["train"].matmul_flops:
        raise AssertionError(f"matmul FLOPs on the card {real.matmul_flops} != on meta "
                             f"{meta['train'].matmul_flops}")
    if real.attention_flops != pairs_flops:
        raise AssertionError(f"attention FLOPs on the card {real.attention_flops} != "
                             f"attention_bound's {pairs_flops}")
    if launches != want_launches:
        raise AssertionError(f"counted step launches {launches}, expected {want_launches}")

    res["op_dispatch"] = op_dispatch_cost(device)
    log("roofline: op dispatch", json.dumps(res["op_dispatch"]))
    res["xlstm-1.3b_train_loops"] = recurrent_count(device)
    log("roofline: xlstm-1.3b train counted", json.dumps(res["xlstm-1.3b_train_loops"]))

    # the dry-run: a fake group of 256 ranks and meta tensors, in its own process
    for arch, shape in (("qwen3-8b", "decode_32k"), ("xlstm-1.3b", "long_500k")):
        with tempfile.TemporaryDirectory() as out:
            t1 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                   arch, "--shape", shape, "--out", out],
                                  capture_output=True, text=True, timeout=300,
                                  env={**os.environ, "PYTHONPATH": str(SRC)})
            if proc.returncode != 0:
                raise AssertionError(f"the dry-run failed ({proc.returncode}): "
                                     f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
            rec = json.loads((Path(out) / f"{arch}__{shape}__pod1__baseline.json").read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"the dry-run's {arch} {shape} cell: {rec['status']}")
        res[f"dryrun_{arch}_{shape}"] = {
            "status": rec["status"], "seconds": time.perf_counter() - t1,
            "trace_s": rec["trace_s"], "roofline": {k: rec["roofline"][k] for k in (
                "bound", "compute_s", "memory_s", "collective_s")},
            "hbm_model": rec["hbm_model"], "summary": proc.stdout.strip().splitlines()[-2:]}
        log("roofline: dry-run", json.dumps(res[f"dryrun_{arch}_{shape}"]))
    res["seconds"] = time.perf_counter() - t0


def recurrent_count(device):
    """xlstm-1.3b at full width cut to its first period (7 mLSTM layers, an
    sLSTM), one AdamW train step (remat) of 1 x ROOFLINE_XLSTM_SEQ packed
    documents counted on the meta device, where each loop over chunks or
    positions runs `counter.SAMPLE` iterations counted as all of them, and
    on the card under the counter, where the loops run whole: their matmul
    FLOPs must be equal (the scaling is exact for the products), and the
    meta count's other terms are set beside the card's."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synth import SyntheticPackedDataset
    from repro_torch.roofline.counter import OpCounter
    from repro_torch.train.optimizer import optimizer_for
    from repro_torch.train.train_step import build_train_step, init_train_state

    cfg = get_arch("xlstm-1.3b")
    tcfg = dataclasses.replace(cfg, n_layers=len(cfg.period))
    opt = optimizer_for(tcfg, lr=1e-3)
    raw = SyntheticPackedDataset(tcfg, ROOFLINE_XLSTM_SEQ, 1, seed=0).batch_at(0)
    t1 = time.perf_counter()
    meta, args = meta_train_count(tcfg, opt, meta_like(raw), 1)
    meta_s = time.perf_counter() - t1
    state = init_train_state(0, tcfg, opt, device=device)
    step = build_train_step(tcfg, opt, microbatches=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with OpCounter() as real:
        step(state, to_device(raw, device))
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    del state, step
    torch.cuda.empty_cache()
    res = {"layers": tcfg.n_layers, "tokens": ROOFLINE_XLSTM_SEQ,
           "meta": {k: v for k, v in meta.as_dict().items() if not k.startswith("top_")},
           "card": {k: v for k, v in real.as_dict().items() if not k.startswith("top_")},
           "meta_count_seconds": meta_s, "card_count_seconds": card_s,
           "argument_bytes": args}
    res["flops_meta_over_card"] = meta.flops / real.flops
    res["hbm_bytes_meta_over_card"] = meta.hbm_bytes / real.hbm_bytes
    if meta.matmul_flops != real.matmul_flops or not meta.scaled_loops:
        raise AssertionError(f"xlstm-1.3b step: matmul FLOPs on meta (loops scaled) "
                             f"{meta.matmul_flops} != on the card {real.matmul_flops}: {res}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    from repro_torch.configs import get_arch
    from repro_torch.configs.paper_models import PAPER_MODELS, PAPER_PARALLELISM
    from repro_torch.kernels import build
    from repro_torch.kernels.packed_flash_attn import BWD_SM90, BWD_TF32, FWD_TF32, SM90
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import tree_leaves

    small = PAPER_PARALLELISM["small"]
    if PIPE_SPECS["llama2-7b"]["plan"] != {k: small[k] for k in ("dp", "pp", "tp")}:
        raise AssertionError(f"llama2-7b's plan is not the paper's small plan {small}")

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record = {"card": smi[0], "torch": torch.__version__, "cuda": torch.version.cuda}

    t_start = t0 = time.perf_counter()
    build.build_all()
    record["build_seconds"] = time.perf_counter() - t0
    record["elapsed_seconds"] = {}

    def mark(name):  # the command's elapsed seconds after each phase
        record["elapsed_seconds"][name] = time.perf_counter() - t_start
        log(f"elapsed {record['elapsed_seconds'][name]:.1f} s after {name}")
    for src, text in build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "warning",
                                       "wgmma")):
                log(f"ptxas {src}: {line.strip()}")
    log(f"build: {record['build_seconds']:.1f} s")
    # the bf16 kernels must run on the tensor cores: HGMMA in their SASS
    record["hgmma_instructions"] = {k.source: sass_count(build.library_path(k.source), "HGMMA")
                                    for k in (SM90, FWD_TF32, BWD_SM90, BWD_TF32)}
    log(f"sass: HGMMA instructions {record['hgmma_instructions']}")
    for kern in (SM90, BWD_SM90):
        if record["hgmma_instructions"][kern.source] == 0:
            raise AssertionError(f"{kern.source}: no HGMMA instruction in its SASS")
    for name, kern, knames, dims, opcode in BUILD_GATES:
        record[name] = kernel_build_check(kern, knames, dims, opcode)
        log(f"build: {name} {json.dumps(record[name])}")
    record["kernels_without_spill"] = spill_check([k.source for k in (SM90, FWD_TF32, BWD_SM90,
                                                                        BWD_TF32)])
    log(f"build: no spill in {record['kernels_without_spill']} kernels by source")

    cfg = get_arch("qwen3-8b")
    record["kernel"] = kernel_phase(cfg, device)
    torch.cuda.empty_cache()
    mark("kernel")
    record["family_kernel"] = family_kernel_phase(device)
    torch.cuda.empty_cache()
    mark("family_kernel")
    record["fp32_path"] = {arch: fp32_phase(get_arch(arch), device) for arch in PARITY_ARCHS}
    mark("fp32")

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    record["params"] = sum(p.numel() for p in tree_leaves(params))
    log(f"qwen3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, {record['params']} parameters, "
        f"init {time.perf_counter() - t0:.1f} s")

    record["forward"] = forward_phase(cfg, params, device)
    served = {}  # what the sharded serving of phase 14 is held to, by arch
    record["serve"] = serve_phase(cfg, params, device, keep=served.setdefault(cfg.arch_id, {}))
    mark("forward+serve")
    del params  # the train phase needs the card's memory
    torch.cuda.empty_cache()
    record["train"] = train_phase(cfg, device, accum_check=True)
    torch.cuda.empty_cache()
    mark("train")
    record["pipeline"] = pipeline_phase(cfg, device, PIPE_SPECS["qwen3-8b"])
    torch.cuda.empty_cache()
    mark("pipeline")
    record["checkpoint"] = checkpoint_phase(cfg, device)
    torch.cuda.empty_cache()
    mark("checkpoint")
    record["cluster"] = cluster_phase()
    mark("cluster")

    # the dense family at full width: gemma3-1b and h2o-danube-1.8b at full
    # depth, the paper's small-scale models (Table 3) at full depth to serve
    fam = record["family"] = {}
    gemma = get_arch("gemma3-1b")
    params = init_params(gemma, seed=0, dtype=torch.bfloat16, device=device)
    fam["gemma3-1b_serve"] = serve_phase(gemma, params, device, check_last=True)
    del params
    torch.cuda.empty_cache()
    fam["gemma3-1b_train"] = train_phase(gemma, device, layers=None, steps=FAMILY_TRAIN_STEPS,
                                         fit=FAMILY_TRAIN_FIT)
    torch.cuda.empty_cache()
    fam["gemma3-1b_pipeline"] = pipeline_phase(gemma, device, PIPE_SPECS["gemma3-1b"])
    torch.cuda.empty_cache()
    fam["h2o-danube-1.8b_train"] = train_phase(get_arch("h2o-danube-1.8b"), device, layers=None,
                                               steps=FAMILY_TRAIN_STEPS, fit=FAMILY_TRAIN_FIT)
    torch.cuda.empty_cache()
    for arch in PAPER_MODELS["small"]:  # llama2-7b, qwen2.5-7b
        pcfg = get_arch(arch)
        params = init_params(pcfg, seed=0, dtype=torch.bfloat16, device=device)
        fam[f"{arch}_serve"] = serve_phase(pcfg, params, device, new_tokens=PAPER_NEW_TOKENS,
                                           check_last=True)
        del params
        torch.cuda.empty_cache()
    fam["llama2-7b_pipeline"] = pipeline_phase(get_arch("llama2-7b"), device,
                                               PIPE_SPECS["llama2-7b"])
    torch.cuda.empty_cache()
    mark("dense family")

    moe_phases(record, device)
    mark("moe")
    multimodal_phases(record, device, served)
    mark("multimodal")
    recurrent_phases(record, device, served)
    mark("recurrent")
    sharding_phase(record, device, served)
    del served
    torch.cuda.empty_cache()
    mark("sharding")
    roofline_phase(record, device)
    torch.cuda.empty_cache()
    mark("roofline")

    record["kernels"] = kernel_entries(record)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": record["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
