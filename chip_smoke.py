"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version on the card at the serving path's
shapes (the packed-corpus kernels also against their unpacked twins on the
decoded corpus), then drives the §1.3 dataset-search service
(``repro_torch.SketchSearchService``, m = 512) with each of the six
families -- ICWS, CountSketch, JL, DMH, threshold and priority sampling,
storage-matched -- over one synthetic lake of 16,384 tables, family by
family: the unpacked store, then ``packed=True``, then both answering the
same queries in alternating turns for their latency, and checks the
answers; it prints each family's planted-partner recall side by side (the
paper's head-to-head).  The pack epilogue of the ICWS and DMH sketches
(B10) is on no serving path; its own path, ``ops.*_sketch(pack_vals=
True)``, is driven and counted apart.  Before the service, the ``corpus``
phase drives the library surface on the same lake:
``repro_torch.SketchCorpus`` ingests its 49,152 field vectors and answers
64 queries one at a time (B3's one-vs-many route) and 16 at a time (B4),
bit for bit equal and within 10 ppm of the host ICWS estimator, and
``ops.icws_estimate`` runs B3's pairwise route.  Before the lake, the
gradient-compression path (``repro_torch.optim.compression``) runs eight
``compressed_update`` steps on the card at one TinyLlama-1.1B layer's
gradient (44,044,288 values), through the dense CountSketch kernel (B14),
and the flash-attention entry point (``repro_torch.kernels.
flash_attention.flash_attention``) runs TinyLlama's attention shape,
Mistral-NeMo's heads, Gemma-7B's and InternVL2-1B's reduced ones (B15: f32
through the f32 tensor-core kernel, bf16 through the bf16 one: by TMA where
D % 8 == 0, value by value at D = 28), each kernel first held against its
plain version.  The ``lm serve`` phase then drives the LM serving path
(``repro_torch.models.Model``, ``repro_torch.launch.serve``'s
``ServeEngine``) at tinyllama-1.1b's full config: decode against the
parallel forward, the card against the CPU at two layers of full width,
the engine draining six requests on four slots twice with the same tokens,
and the decode-step p50, forward time, tokens/s and peak memory; the path
launches no hand-written kernel (every counter reads 0 after it).  The
``lm train`` phase drives the training path (``repro_torch.train``'s
``Trainer``, ``make_train_step``, AdamW, checkpoints) at the same config:
one train step of the card against the CPU at two layers, the 22-layer
Trainer straight and resumed from a checkpoint, bit for bit, its step
p50, tokens/s, peak memory and a profiled step; training launches no
hand-written kernel, and its sketch gradient telemetry
(``train/telemetry.py``) runs B1 and B3 on the micro-batches' whole
gradients (T = 1,100,048,384), counted as ``train_launches``.
After the service runs, the ``merge`` phase builds lakes through
``ingest_many_sharded`` (4 shards; ICWS the whole lake, the other
families a 2,048-table sub-lake, each beside a single-stream service:
every planted partner first; CS and JL equal to single-stream on an
integer lake), holds each family's ``merge_rows`` (commutes bit for bit;
ICWS and DMH against the host merge) and times ``merge_stores``; the
``host oracle`` phase serves an ICWS service's host WeightedMinHash
sketches beside the card, then, with observability on, audits its
searches against them (``audit_every=1``); the ``paper baselines`` phase
runs the paper's head-to-head on the host through the port's registry
(``repro_torch.core.make``, all nine methods at storage 400 on fig4's fast
grid of ``sparse_pair`` inputs, stopping on a failed merge, brute-force or
rounding identity) and the paper's method on the card through
``SketchCorpus`` (held against its plain version on the same vectors and
within 1e-7 of the host ICWS estimator).  Each family's
``observability`` phase replays its queries on both services with
``repro_torch.obs`` on: the same results bit for bit, and each op's
``ops.launches_total`` equal to its kernels' launch counters; for ICWS the
``search`` p50 with observability off and on, and the disabled wrapper's
cost.  The lake services pass ``keep_host_oracle=False``.
Imports nothing of JAX and nothing of the JAX package.  Exits non-zero on
any failure, and at once when no card is present.  Each phase prints its
wall time.  The line before the last is a JSON object with each kernel's
launches on the serving runs and the sharded builds (B10 also on its own
path; B3 and B4 on the corpus path; B14 and B15 on theirs; B1 and B3 also
on the training telemetry's),
its error against the plain version, its time, the plain version's time, its bound and the time of one PyTorch
call that computes the same function (where there is one); the last line
is the run's device.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SRC = pathlib.Path(__file__).resolve().parent / "src"

# published peaks of one H100 SXM (the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the FP32 rate of
# the CUDA cores, which every 32-bit lane operation here is counted at)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 instructions per second: one per lane and clock, the rate above with
# a fused multiply-add counted as two operations.  The linear dots (B8, B12)
# take an f32 product and an f32 add per term, never an FMA, so their
# operations are also their instructions, and this rate is their floor
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
# lane operations of one (row, t, non-zero) ICWS draw: ten murmur rounds
# (8 each), five salted hash prologues (5), five uniforms (4), and the
# r / c / beta / level / exp / divide chain (19, one per log, exp, divide)
ICWS_OPS_PER_DRAW = 10 * 8 + 5 * 5 + 5 * 4 + 19
# lane operations of one (g, q, p, t) collision test (compare, guard), and
# of one collision's weight (two squares, min, select, product, divide,
# two adds)
EST_OPS_PER_TEST = 2
EST_OPS_PER_HIT = 8
# lane operations of one keyed hash (two murmur rounds and the prologue);
# one CountSketch term per (row, rep, live non-zero) takes two hashes, the
# bucket's modulo, the sign's select, its product and the add; one JL term
# per (row, t, live non-zero) one hash, select, product and add
HASH_OPS = 2 * 8 + 5
CS_OPS_PER_TERM = 2 * HASH_OPS + 4
JL_OPS_PER_TERM = HASH_OPS + 3
# clocks of one dependent f32 add on Hopper: a serial sum's floor per term
CHAIN_CLOCKS_PER_ADD = 4
# DMH: per lane one bin hash and its modulo, the five salted ICWS variates
# and the level chain, and the atomicMin; per occupied bin the winner's
# level again and its fingerprint hash; per densify probe a hash, the
# modulo and the occupancy test
DMH_OPS_PER_LANE = HASH_OPS + 1 + ICWS_OPS_PER_DRAW + 1
DMH_OPS_PER_BIN = ICWS_OPS_PER_DRAW + HASH_OPS
DMH_OPS_PER_PROBE = HASH_OPS + 2
# key-match merge: per step (one query slot or one corpus slot passed) a
# compare and an advance; per match the min, the guard, the product, the
# divide and the add
SAMPLE_OPS_PER_STEP = 2
SAMPLE_OPS_PER_MATCH = 5

M = 512
LAKE_TABLES = 16_384
QUERIES = 64
MICRO_BATCH = 16
QUERY_ROWS = 2_000
KEY_DOMAIN = 1 << 20
EST_P = 131_072
FAMILIES = ("icws", "cs", "jl", "dmh", "ts", "ps")
# the kernels each family's serving path launches: its sketch kernel (none
# for TS/PS, whose rows are built on the host) and its estimate kernel
PATH_KERNELS = {"icws": ("icws_sketch", "estimate_fields"),
                "cs": ("countsketch_sparse", "linear_estimate_fields"),
                "jl": ("jl_sketch", "linear_estimate_fields"),
                "dmh": ("dmh_sketch", "estimate_fields"),
                "ts": ("sample_estimate_fields",),
                "ps": ("sample_estimate_fields",)}
# the packed service's: the same sketch kernel (ICWS ingests the lake; the
# others fill their store from the unpacked run's rows, so it sketches
# only queries) and the packed estimate kernel.  The store packs with
# pack_rows, as the JAX store does, so the pack epilogue (B10) is on no
# serving path: its own path is the ops entry point
PACKED_PATH_KERNELS = {
    "icws": ("icws_sketch", "estimate_fields_packed"),
    "cs": ("countsketch_sparse", "linear_estimate_fields_packed"),
    "jl": ("jl_sketch", "linear_estimate_fields_packed"),
    "dmh": ("dmh_sketch", "estimate_fields_packed"),
    "ts": ("sample_estimate_fields_packed",),
    "ps": ("sample_estimate_fields_packed",)}
# B10's path: tables that ops.icws_sketch / ops.dmh_sketch(pack_vals=True)
# sketch and pack, 16 per launch, appended by CorpusStore.append_packed
B10_TABLES = 2_048
B10_PATH_KERNEL = {"icws": "icws_sketch_packed", "dmh": "dmh_sketch_packed"}
# rounds of the latency comparison, unpacked (A) and packed (B) in turn
LATENCY_ORDER = "ABBAABBA"
# sharded serving: each family's index again over the rows its service
# holds, split over 2 shards of cuda:0 (ICWS also over 3, which 16,384 rows
# do not fill evenly); its search p50 beside the single-device service's in
# turns A (single device) B (2 shards)
SHARDS = (2, 3)
SHARDED_TURNS = "ABBA"
# the corpus path: SketchCorpus ingests every field vector of the lake in
# batches of 48 and answers the first field vector of each query; its
# estimates are held against the host ICWS estimator on 1,024 rows
CORPUS_BATCH = 48
CORPUS_HOST_ROWS = 1_024
# the rows estimate_vec runs over: the store's capacity, which doubles from
# 64 past the lake's 3 x 16,384 field vectors
CORPUS_P = 1 << (3 * LAKE_TABLES - 1).bit_length()
CORPUS_KERNELS = ("icws_sketch", "estimate_pairs", "estimate_one_vs_many",
                  "estimate_many")
# the merge phase (m = 512, unpacked, 4 shards): every family ingests a
# sub-lake of the 32 planted partners and the lake's first 2,016 other
# tables through ingest_many_sharded, beside a single-stream service of it
# (a depth cut for time: ICWS took the whole lake, 16,384 tables, until the
# lm train phase came); CS and JL also an integer-valued separated lake of
# 512 tables of 500-2,000 rows, where their sharded build equals the
# single-stream one; merge_stores is timed on two 16,384-row, 3-field
# stores (the sub-lake's shard rows, eight times over), its merge_rows
# checked on the sub-lake's first 256 tables
MERGE_SHARDS = 4
MERGE_SUBLAKE = 2_048
MERGE_ROWS = 16_384
MERGE_CHECK_TABLES = 256
INT_LAKE_TABLES = 512
# the host oracle phase: an ICWS service keeping its host WeightedMinHash
# sketches over the first 6 planted partners and 6 other tables under
# 2,000 rows, queried with the partners' queries
HOST_TABLES = 6
# the paper baselines phase: the paper's head-to-head at fig4's fast grid
# (benchmarks/fig4_synthetic.py --fast: default_rng(42), two sparse_pair
# pairs an overlap, n = 10,000, nnz = 2,000, two seeds) at storage 400 a
# sketch; the brute-force WeightedMinHash gate expands L = 1,000 slots of a
# 40-entry vector; the card's SketchCorpus estimates lie within
# PAPER_CARD_TOL (normalized by ||a|| ||b||) of the host ICWS estimator's:
# f32 sums against f64 ones, about 1e-8 on these pairs; and bit for bit
# those of a SketchCorpus on the cpu (the norm epilogue divides by m as a
# 0-d device tensor, as the cpu does: the "norm epilogue" phase holds it
# to the cpu's bits)
PAPER_OVERLAPS = (0.01, 0.05, 0.10, 0.50)
PAPER_STORAGE = 400
PAPER_PAIRS = 2
PAPER_SEEDS = 2
BRUTE_L = 1_000
BRUTE_NNZ = 40
PAPER_CARD_TOL = 1e-7
# the gradient-compression path sketches the gradient of one TinyLlama-1.1B
# decoder layer (repro/configs/tinyllama_1_1b.py: d_model 2048, 32 heads,
# 4 KV heads, head_dim 64, d_ff 5632): q, k, v and o projections, the
# SwiGLU MLP's three matrices and the two RMSNorm scales, 44,044,288
# values, with CompressionConfig's defaults (width 4096, 5 reps, seed 17)
TL_D_MODEL, TL_HEADS, TL_KV_HEADS, TL_HEAD_DIM, TL_D_FF = 2048, 32, 4, 64, 5632
GRAD_T = (TL_D_MODEL * (2 * TL_HEADS + 2 * TL_KV_HEADS) * TL_HEAD_DIM
          + 3 * TL_D_MODEL * TL_D_FF + 2 * TL_D_MODEL)
COMPRESS_STEPS = 8
# flash attention at TinyLlama's attention (B = 1, T = S = 4,096), and
# cases at Mistral-NeMo's heads (repro/configs/mistral_nemo_12b.py: 32
# heads, 8 KV heads, head_dim 128), Gemma-7B's (repro/configs/gemma_7b.py:
# 16 heads, 16 KV heads, head_dim 256; the f32 tensor-core kernel splits
# the head dim between its two warpgroups there) and InternVL2-1B's reduced
# ones (repro/configs/internvl2_1b.py REDUCED: 2 heads, 1 KV head, head_dim
# 28, not a multiple of 8, so the bf16 kernel's by-value loads), and at
# those heads a width of 40 (a multiple of 8, not of 16: TMA loads with the
# head dim padded to 64 inside the kernel; no published config has it):
# label, H, K, D, dtype, window, and the (rtol, atol) against the plain
# version (the TPU kernel's f32 function): f32 the JAX tests' 5e-5 (the f32
# tensor-core kernel splits q scale, k, v and p into three bf16 parts and
# sums six part-products: within f32 rounding).  bf16 one bf16 rounding
# step: the bf16 cases run the bf16 tensor-core kernel, whose s sums exact
# bf16 products in f32 before the scale and whose p v is p_hi v + p_lo v (p
# split into two bf16 parts), so it stays within f32 rounding of that
# function and differs where the results round to neighbouring bf16 values
FLASH_T = 4096
F32_TOL, BF16_TOL = (5e-5, 5e-5), (2 ** -7, 1e-5)
FLASH_CASES = (
    ("causal f32", TL_HEADS, TL_KV_HEADS, TL_HEAD_DIM, torch.float32, 0,
     F32_TOL),
    ("causal bf16", TL_HEADS, TL_KV_HEADS, TL_HEAD_DIM, torch.bfloat16, 0,
     BF16_TOL),
    ("causal f32 window 1024", TL_HEADS, TL_KV_HEADS, TL_HEAD_DIM,
     torch.float32, 1024, F32_TOL),
    ("causal f32 D=128", 32, 8, 128, torch.float32, 0, F32_TOL),
    ("causal bf16 D=128", 32, 8, 128, torch.bfloat16, 0, BF16_TOL),
    ("causal f32 D=256", 16, 16, 256, torch.float32, 0, F32_TOL),
    ("causal bf16 D=256", 16, 16, 256, torch.bfloat16, 0, BF16_TOL),
    ("causal bf16 D=28", 2, 1, 28, torch.bfloat16, 0, BF16_TOL),
    ("causal bf16 D=40", 2, 1, 40, torch.bfloat16, 0, BF16_TOL))
# the cases held per head == batched, bit for bit
FLASH_PER_HEAD = ("causal f32", "causal bf16", "causal f32 window 1024",
                  "causal f32 D=128", "causal bf16 D=128", "causal f32 D=256",
                  "causal bf16 D=256", "causal bf16 D=28", "causal bf16 D=40")
# the flash_attention entry point against the port's chunked_attention
# (scale after the product, bf16 p before p v): the JAX tests' tolerances
ORACLE_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# dense bf16 rate of the tensor cores: every B15 route's bound.  bf16
# inputs (the bf16 tensor-core kernel): 6 operations per visible (query,
# key) pair and dim, p v taken twice; beside it the 4-operation bound of a
# kernel with one bf16 p.  f32 inputs (the f32 tensor-core kernel): 24, six
# part-products each for q k^T and p v; beside it the 4-operation floor of
# f32 FMAs on the CUDA cores
BF16_TC_OPS_PER_S = 989e12
# operations per visible pair and dim, by the kernel the route takes
FLASH_OPS = {"flash_attention_tc_kernel": 6,
             "flash_attention_f32tc_kernel": 24}
# the LM serving path at tinyllama-1.1b's full config (22 layers, d 2048,
# 32 heads, 4 KV heads, head_dim 64, d_ff 5632, vocab 32,000; random
# weights from a seeded generator on the card).  Gates: decode == parallel
# forward within JAX's own rel < 0.06 (tests/test_models.py) at B = 1, T =
# 12; the card against the CPU at LM_CPU_LAYERS of full width within the
# CPU tests' tolerance (tests/test_torch_lm.py: 2^-6 of the largest CPU
# magnitude; greedy picks equal but at a near tie, where the CPU's top-2
# margin lies within it); the engine drains LM_REQUESTS on LM_SLOTS and a
# repeat gives the same tokens
LM_ARCH = "tinyllama-1.1b"
LM_TOL = 2 ** -6
LM_DECODE_REL = 0.06
LM_T = 12
LM_CPU_LAYERS = 2
LM_CPU_B, LM_CPU_T = 2, 8
LM_SLOTS, LM_REQUESTS, LM_NEW, LM_MAX_SEQ = 4, 6, 8, 256
LM_FORWARD_T = 512
LM_STEPS = 32

# lm train: (a) one train step at LM_CPU_LAYERS of full width on the card
# and on the CPU (M = 2 micro-batches of one LM_TRAIN_CPU_T row), held at
# the CPU tests' tiers (tests/test_torch_train.py: the loss at LM_TOL, each
# gradient leaf and the bf16 moments within LM_GRAD_TOL of the largest CPU
# magnitude, the updates on the entries whose first moment is at least
# LM_WELL_POSED of the largest, at most LM_ILL_SHARE of the others off);
# (b) tinyllama-1.1b's 22 layers through the Trainer: LM_TRAIN_B x
# LM_TRAIN_SEQ tokens a step in LM_TRAIN_M micro-batches, LM_TRAIN_STEPS
# straight and again with a checkpoint after LM_TRAIN_RESUME steps and a
# fresh Trainer restoring it, equal bit for bit; (c) the sketch gradient
# telemetry on the micro-batches' flattened gradients (m = TEL_M), B1 at
# B1's gate and B3 bit for bit against their plain versions (B1 on the
# rows' first TEL_PLAIN_N entries: the plain version holds [m, N]), the
# estimated cosines within TEL_COS_GATE of the exact ones (about four
# standard errors of an m = 256 sketch)
LM_GRAD_TOL = 2 ** -5
LM_WELL_POSED = 2 ** -4
LM_ILL_SHARE = 0.05
LM_TRAIN_CPU_T = 64
LM_TRAIN_B, LM_TRAIN_SEQ, LM_TRAIN_M = 8, 512, 2
LM_TRAIN_STEPS, LM_TRAIN_RESUME = 4, 2
TEL_M = 256
TEL_PLAIN_N = 1 << 20
TEL_COS_GATE = 0.35

# lm moe: qwen3-moe-30b-a3b at its published widths (d 2,048, 32/4 heads of
# 128, 128 experts top 8 of d_ff 768, vocab 151,936), depth cut to
# MOE_LAYERS of 48 (5,607,294,976 parameters, 22.43 GB f32; all 48 are
# 122.1 GB, which init refuses before it allocates).  The routing rule
# holds wherever two runs' routes are compared: a token whose top-k expert
# set differs must sit at a near tie of the reference's routing (its k-th
# and (k+1)-th probabilities within MOE_ROUTE_MARGIN of the k-th), unless
# its input already differs (a token at or before it in its sequence was
# routed apart in an earlier layer); such tokens are counted, outputs are
# compared on the tokens with none routed apart at or before them, and a
# gradient step on the card replays the CPU's routing.  Gates: (a) decode ==
# forward over MOE_DECODE_B sequences at capacity_factor MOE_DECODE_CF =
# E / k, so that the forward drops no token (the published 1.25 drops past
# 40 a expert at T = 512; JAX's own test raises it likewise), rel <
# LM_DECODE_REL; the two runs' activations differ by bf16 steps that add up
# over the layers (up to LM_DECODE_REL, JAX's gate), so the routing rule's
# margin there is LM_DECODE_REL (one f32 ulp apart, card and CPU take
# MOE_ROUTE_MARGIN); (b) the card against the CPU at LM_CPU_LAYERS of full
# width, on the logits and on one loss-and-gradient step's loss, aux and
# gradients (LM_TOL; the gradients at LM_GRAD_TOL on the entries at least
# LM_WELL_POSED of their leaf's largest, at most LM_ILL_SHARE of the others
# off, as lm train (a)); (c) the launcher's engine
# drains LM_REQUESTS on LM_SLOTS twice, same tokens; (e) a LM_CPU_LAYERS
# Trainer of LM_TRAIN_STEPS steps at LM_TRAIN_B x LM_TRAIN_SEQ in
# LM_TRAIN_M micro-batches, twice, bit for bit
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 8
MOE_DECODE_CF = 16.0
MOE_DECODE_B = 4
MOE_ROUTE_MARGIN = 2 ** -6
MOE_GRAD_B, MOE_GRAD_T = 2, 64

# lm vlm: internvl2-1b's whole published config (24 layers, 896 wide, 14/2
# heads of 64, vocab 151,655, 256 patch embeddings of the stubbed vision
# frontend): the forward over VLM_PATCHES patches and VLM_T tokens, the
# card against the CPU at LM_CPU_LAYERS on the text logits and one
# loss-and-gradient step, the engine (text only, as JAX's) twice
VLM_ARCH = "internvl2-1b"
VLM_T = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase(name: str, fn, *args):
    """Run one phase and print its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


class LaunchCount:
    """A launch counter kept under another attribute than ``launches``:
    B15's per-kernel counts on ``flash_attention_cuda``."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int):
        setattr(self.fn, self.attr, n)


def launch_counters():
    """Each kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import (countsketch, dmh_sketch, estimate,
                                     flash_attention, icws_sketch, jl_sketch,
                                     sample_estimate)
    flash = flash_attention.flash_attention_cuda
    return {"icws_sketch": icws_sketch.icws_sketch_cuda,
            "estimate_fields": estimate.estimate_fields_cuda,
            "countsketch_sparse": countsketch.countsketch_sparse_cuda,
            "jl_sketch": jl_sketch.jl_sketch_cuda,
            "linear_estimate_fields": estimate.linear_estimate_fields_cuda,
            "dmh_sketch": dmh_sketch.dmh_sketch_cuda,
            "sample_estimate_fields":
                sample_estimate.sample_estimate_fields_cuda,
            "icws_sketch_packed": icws_sketch.icws_sketch_packed_cuda,
            "dmh_sketch_packed": dmh_sketch.dmh_sketch_packed_cuda,
            "estimate_fields_packed": estimate.estimate_fields_packed_cuda,
            "estimate_pairs": estimate.estimate_partials_cuda,
            "estimate_one_vs_many": estimate.estimate_one_vs_many_cuda,
            "estimate_many": estimate.estimate_many_vs_many_cuda,
            "linear_estimate_fields_packed":
                estimate.linear_estimate_fields_packed_cuda,
            "sample_estimate_fields_packed":
                sample_estimate.sample_estimate_fields_packed_cuda,
            "countsketch_dense": countsketch.countsketch_dense_cuda,
            "flash_attention_tc": LaunchCount(flash, "tc_launches"),
            "flash_attention_f32tc": LaunchCount(flash, "f32tc_launches")}


def family_for(name: str):
    from repro_torch.data.families import make_family, wmh_storage
    return make_family(name, storage=wmh_storage(M), seed=0)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``: CUDA events around a run of ``reps``
    calls, over the count.  A call that is shorter on the device than on
    the host (the wrapper's Python) reads as the host's time per call."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, symbols, reps: int = 10, traces: int = 4, names=None):
    """Device milliseconds per call of ``fn``, from a ``torch.profiler``
    trace of ``reps`` calls: for each name in ``symbols`` (one or a tuple,
    where a call launches several kernels) the mean over the launches of
    the kernel whose name contains it, summed over the names; the kernels
    alone, without the host's launch cost.  A trace can come back without
    the device's activity (on an H100, late in a long run, every trace of
    one kernel has); after ``traces`` such traces, each logged, the time
    comes from CUDA events around single calls of ``fn`` instead (the
    median of ``reps``, which also counts the launches' own latency).
    Returns (ms, source), source ``"profiler"`` or ``"events"``; a list
    given as ``names`` receives the traced kernels' full names (template
    arguments included), each once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    symbols = (symbols,) if isinstance(symbols, str) else tuple(symbols)
    fn()
    torch.cuda.synchronize()
    for attempt in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = {sym: [e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA and sym in e.name]
                 for sym in symbols}
        if all(spans.values()):
            if names is not None:
                names.extend(sorted({e.name for e in prof.events()
                                     if e.device_type == DeviceType.CUDA
                                     and any(s in e.name for s in symbols)}))
            for sym, v in spans.items():
                if max(v) > 1.5 * min(v):   # a trace to look into
                    log(f"device_ms: {len(v)} launches of {sym} in "
                        f"{reps} calls, {min(v) / 1e3:.4f} to "
                        f"{max(v) / 1e3:.4f} ms")
            return sum(sum(v) / len(v) for v in spans.values()) / 1e3, \
                "profiler"
        log(f"device_ms: trace {attempt + 1} recorded no launch of "
            + ", ".join(sym for sym, v in spans.items() if not v))
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    log(f"device_ms: {', '.join(symbols)} timed with CUDA events around "
        f"single calls, the profiler having recorded none of its launches")
    return statistics.median(times), "events"


# --------------------------------------------------------------------------
# synthetic lake: tables over a shared key domain with duplicate keys
# --------------------------------------------------------------------------
def make_lake(rng, n_tables: int, n_queries: int):
    """``n_tables`` tables, sizes log-uniform in [100, 10,000] rows, keys
    drawn with replacement from a 2^20 domain; queries of 2,000 rows, the
    first half each with a planted partner table that shares ~85% of its
    rows with values that follow the query's.  Returns (tables, queries,
    partner name per query or None)."""
    tables = []
    sizes = np.exp(rng.uniform(np.log(100), np.log(10_000), n_tables))
    for i, n in enumerate(sizes.astype(np.int64)):
        tables.append((f"t{i:05d}", rng.integers(0, KEY_DOMAIN, n),
                       rng.normal(100.0, 15.0, n)))
    queries, partners = [], []
    slots = rng.choice(n_tables, size=n_queries // 2, replace=False)
    for qi in range(n_queries):
        keys = rng.integers(0, KEY_DOMAIN, QUERY_ROWS)
        vals = rng.normal(0.0, 1.0, QUERY_ROWS)
        queries.append((keys, vals))
        if qi < n_queries // 2:
            keep = rng.random(QUERY_ROWS) < 0.85
            extra = int(rng.integers(100, 2_000))
            pk = np.concatenate([keys[keep], rng.integers(0, KEY_DOMAIN, extra)])
            pv = np.concatenate([3.0 * vals[keep] + 0.3 * rng.normal(size=keep.sum()),
                                 rng.normal(0.0, 3.0, extra)])
            name = f"partner{qi:02d}"
            tables[slots[qi]] = (name, pk, pv)
            partners.append(name)
        else:
            partners.append(None)
    return tables, queries, partners


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {build.library_path()} built or loaded in "
        f"{time.perf_counter() - t0:.1f} s")


def field_vectors(index, rng, B: int, nnz: int):
    """B field vectors (3 per table) of about ``nnz`` non-zeros each."""
    vecs = []
    while len(vecs) < B:
        keys = rng.integers(0, KEY_DOMAIN, nnz + nnz // 64)
        vecs.extend(index.vectorize(keys, rng.normal(0.0, 1.0, keys.size)))
    return vecs[:B]


def padded_rows(index, rng, B: int, nnz: int, dev):
    """B padded field rows ``(w, keys, vals)`` of about ``nnz`` non-zeros
    on the card, unreplicated: what the ingest path hands the ICWS sketch,
    and the DMH sketch with ``replicas = dmh_replication(m)`` (4 at m =
    512)."""
    from repro_torch.data.ingest import pad_sparse_batch
    w, keys, vals, _ = pad_sparse_batch(field_vectors(index, rng, B, nnz))
    return [torch.from_numpy(a).to(dev) for a in (w, keys, vals)]


@functools.lru_cache(maxsize=None)
def loop_instructions(symbol: str):
    """{function: SASS instructions of one unit of work (a B1 draw, a B5
    lane, a B6 or B7 term) in the hot loop of each built instance of the
    kernel ``symbol`` (``tools/sass_loops.py``)}, or None where
    ``cuobjdump`` is missing."""
    sys.path.insert(0, str(SRC.parent / "tools"))
    import sass_loops
    from repro_torch.kernels import build
    try:
        return sass_loops.per_unit(build.library_path(), symbol)
    except (OSError, subprocess.SubprocessError) as e:
        log(f"{symbol} loops not counted: {e}")
        return None


def unit_instructions(symbol: str, instance: str):
    """The SASS instructions a unit of work of the instance of ``symbol``
    whose mangled name holds ``instance``, or None."""
    return next((n for name, n in (loop_instructions(symbol) or {}).items()
                 if instance in name), None)


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi``'s ``clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.split()[0]) * 1e6


def sketch_case(index, rng, B: int, nnz: int, dev):
    """One sketch launch at the path's shapes: B field rows (3 per table or
    query) of about ``nnz`` non-zeros each, N = nnz rounded to 256."""
    from repro_torch.kernels import icws_sketch as ks
    args = padded_rows(index, rng, B, nnz, dev)
    N = args[0].shape[1]
    got = ks.icws_sketch_cuda(*args, m=M, seed=0)
    torch.cuda.synchronize()
    want = ks.icws_sketch_plain(*args, m=M, seed=0)
    agree = got[0] == want[0]
    share = agree.float().mean().item()
    err = float((got[1] - want[1])[agree].abs().max().item())
    if share < 0.99:
        raise AssertionError(f"sketch B={B}: fingerprints agree on {share:.4f} < 0.99")
    if err != 0.0 or not torch.equal(got[3][agree], want[3][agree]):
        raise AssertionError(f"sketch B={B}: values/argkeys differ where "
                             f"fingerprints agree (max |dval| {err})")
    live, ops, bytes_moved = icws_work(args)
    bound = max(ops / FP32_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S) * 1e3
    ms = time_ms(lambda: ks.icws_sketch_cuda(*args, m=M, seed=0), reps=20)
    dev_ms, dev_src = device_ms(
        lambda: ks.icws_sketch_cuda(*args, m=M, seed=0), "icws_sketch_kernel")
    plain = time_ms(lambda: ks.icws_sketch_plain(*args, m=M, seed=0), reps=3,
                    warmup=1)
    shape = f"B={B} N={N} m={M}"
    group = ks._group_size(B, M, N)
    # the instruction floor: every draw's SASS instructions, one a lane and
    # clock
    per_draw = unit_instructions("icws_sketch_kernel", "ILb0E")
    floor = live * M * per_draw / FP32_INSTR_PER_S * 1e3 if per_draw else None
    log(f"sketch {shape}: fp agree {share:.6f}, max |dval| {err}, "
        f"kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device, "
        f"{group} threads a (row, t) pair), plain "
        f"{plain:.3f} ms, bound {bound:.4f} ms (operations, {live} live "
        f"non-zeros)" + (f", instruction floor {floor:.4f} ms ({per_draw:g} "
                         "SASS instructions a draw)" if floor else ""))
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src, "group_size": group,
            "plain_ms": plain, "bound_ms": bound, "fp_agree": share,
            "instr_per_draw": per_draw, "floor_ms_instructions": floor}


def icws_work(args):
    """Live non-zeros, lane operations and bytes of one ICWS sketch launch
    over ``args = (w, keys, vals)`` [B, N]: three input planes, four
    [B, m] output planes."""
    live = int((args[0] > 0).sum().item())
    return (live, ICWS_OPS_PER_DRAW * live * M,
            args[0].numel() * 12 + args[0].shape[0] * M * 16)


def estimate_case(fq, vq, fc, vc):
    """One estimate launch against its plain version: ``cnt`` and ``sw``
    equal bit for bit on every (g, q, p) (the same IEEE operations in the
    same t order: the port contract)."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import estimate as ke

    def kernel():
        return ke.estimate_fields_cuda(fq, vq, fc, vc, qmap=QFIELD,
                                       cmap=CFIELD)
    cnt, sw = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cnt_p, sw_p = ke.estimate_fields_plain(fq, vq, fc, vc, qmap=QFIELD,
                                           cmap=CFIELD)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    G, Q, P = len(QFIELD), fq.shape[1], fc.shape[1]
    shape = f"G={G} Q={Q} P={P} m={M}"
    err = float((sw - sw_p).abs().max().item())
    if not (bits_equal(cnt, cnt_p) and bits_equal(sw, sw_p)):
        raise AssertionError(f"estimate {shape}: differs from plain (max "
                             f"|dsw| {err})")
    hits = float(cnt.double().sum().item())
    tests = G * Q * P * M
    ops = EST_OPS_PER_TEST * tests + EST_OPS_PER_HIT * hits
    bytes_moved = (fq.numel() + vq.numel() + fc.numel() + vc.numel()) * 4 \
        + 2 * G * Q * P * 4
    bound, bound_by = bound_of(bytes_moved, ops)
    ms = time_ms(kernel, reps=10)
    names = []
    dev_ms, dev_src = device_ms(kernel, "estimate_fields_kernel", names=names)
    log(f"estimate {shape}: {hits:.0f} collisions of {tests} tests, cnt and "
        f"sw equal to plain bit for bit, kernel {ms:.4f} ms per call "
        f"({dev_ms:.4f} ms on the device, {', '.join(names)}), plain "
        f"{plain:.1f} ms (one run), bound {bound:.4f} ms ({bound_by}: "
        f"{bytes_moved / 1e9:.3f} GB, {ops:.3e} ops)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src, "kernel": ", ".join(names),
            "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by}


def linear_sketch_case(index, rng, name: str, B: int, nnz: int, dev):
    """One CountSketch or JL launch at the path's shapes against its plain
    version: equal bit for bit (both sum over ascending n).  Beside the
    bound, the issue floor (the live terms' SASS instructions, one a lane
    and clock) and for JL the chain floor (N dependent adds of
    ``CHAIN_CLOCKS_PER_ADD`` clocks at the card's highest SM clock)."""
    from repro_torch.data.ingest import pad_linear_batch
    from repro_torch.kernels import countsketch as kc
    from repro_torch.kernels import jl_sketch as kj
    fam = family_for(name)
    keys, vals = (torch.from_numpy(a).to(dev) for a in pad_linear_batch(
        field_vectors(index, rng, B, nnz)))
    if name == "cs":
        kw = dict(width=fam.width, reps=fam.reps, seed=0)
        kernel, plain = kc.countsketch_sparse_cuda, kc.countsketch_sparse_plain
        ops_per_term, terms_per_nz = CS_OPS_PER_TERM, fam.reps
        symbol, tile = "countsketch_sparse_kernel", None
    else:
        kw = dict(m=fam.m, seed=0)
        kernel, plain = kj.jl_sketch_cuda, kj.jl_sketch_plain
        ops_per_term, terms_per_nz = JL_OPS_PER_TERM, fam.m
        symbol, tile = "jl_sketch_kernel", kj._t_tile(B, fam.m)
    got = kernel(keys, vals, **kw)
    torch.cuda.synchronize()
    want = plain(keys, vals, **kw)
    err = float((got - want).abs().max().item())
    shape = f"B={B} N={keys.shape[1]} R={fam.reps} W={fam.width}"
    if not torch.equal(got, want):
        raise AssertionError(f"{name} sketch {shape}: kernel differs from "
                             f"plain (max |d| {err})")
    live = int((vals != 0).sum().item())
    ops = ops_per_term * live * terms_per_nz
    bytes_moved = (keys.numel() + vals.numel()) * 4 + got.numel() * 4
    bound_b, bound_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    bound = max(bound_b, bound_o) * 1e3
    bound_by = "bytes" if bound_b >= bound_o else "operations"
    ms = time_ms(lambda: kernel(keys, vals, **kw), reps=20)
    names = []
    dev_ms, dev_src = device_ms(lambda: kernel(keys, vals, **kw), symbol,
                                names=names)
    plain_ms = time_ms(lambda: plain(keys, vals, **kw), reps=3, warmup=1)
    per_term = unit_instructions(symbol, f"ILi{tile}E" if tile else symbol)
    floor_issue = (live * terms_per_nz * per_term / FP32_INSTR_PER_S * 1e3
                   if per_term else None)
    floor_chain = (keys.shape[1] * CHAIN_CLOCKS_PER_ADD / sm_clock_hz() * 1e3
                   if name == "jl" else None)
    log(f"{name} sketch {shape}: equal to plain, kernel {ms:.4f} ms per call "
        f"({dev_ms:.4f} ms on the device, {', '.join(names) or symbol}), "
        f"plain {plain_ms:.3f} ms, bound {bound:.5f} ms ({bound_by}, {live} "
        f"live non-zeros)"
        + (f", issue floor {floor_issue:.5f} ms ({per_term:g} SASS "
           "instructions a term)" if per_term else "")
        + (f", chain floor {floor_chain:.5f} ms" if floor_chain else ""))
    rep = {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
           "device_ms_source": dev_src, "kernel": ", ".join(names),
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
           "instr_per_term": per_term, "floor_ms_issue": floor_issue}
    if name == "jl":
        rep.update(tile=tile, floor_ms_chain=floor_chain)
    return rep


def linear_estimate_case(name: str, tq, tc):
    """One linear-fields launch against its plain version (equal bit for
    bit: an f32 product then an f32 add per w, in order, in both) and
    against ``torch.bmm`` in f32 with TF32 off over the (pair, rep)-gathered
    tables (the gather is outside the timing; the port never calls it)."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import estimate as ke
    G, (Q, R, W), P = len(QFIELD), tq.shape[1:], tc.shape[1]
    shape = f"{name} G={G} R={R} Q={Q} P={P} W={W}"
    got = ke.linear_estimate_fields_cuda(tq, tc, qmap=QFIELD, cmap=CFIELD)
    torch.cuda.synchronize()
    plain_ms = time_ms(lambda: ke.linear_estimate_fields_plain(
        tq, tc, qmap=QFIELD, cmap=CFIELD), reps=1, warmup=0)
    want = ke.linear_estimate_fields_plain(tq, tc, qmap=QFIELD, cmap=CFIELD)
    err = float((got - want).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"linear estimate {shape}: kernel differs from "
                             f"plain (max |d| {err})")
    del want
    ms = time_ms(lambda: ke.linear_estimate_fields_cuda(
        tq, tc, qmap=QFIELD, cmap=CFIELD), reps=10)
    dev_ms, dev_src = device_ms(lambda: ke.linear_estimate_fields_cuda(
        tq, tc, qmap=QFIELD, cmap=CFIELD), "linear_estimate_fields_kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.stack([tq[qf] for qf in QFIELD]).permute(0, 2, 1, 3).reshape(
        G * R, Q, W).contiguous()
    b = torch.stack([tc[cf] for cf in CFIELD]).permute(0, 2, 1, 3).reshape(
        G * R, P, W).contiguous()
    lib = torch.bmm(a, b.transpose(1, 2))
    lib_err = float((lib.reshape(G, R, Q, P) - got).abs().max().item())
    lib_ms = time_ms(lambda: torch.bmm(a, b.transpose(1, 2)), reps=10)
    del a, b, lib
    bytes_moved = (tq.numel() + tc.numel() + got.numel()) * 4
    ops = 2 * G * R * Q * P * W
    bound_b, bound_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    bound = max(bound_b, bound_o) * 1e3
    bound_by = "bytes" if bound_b >= bound_o else "operations"
    log(f"linear estimate {shape}: equal to plain, kernel {ms:.4f} ms per "
        f"call ({dev_ms:.4f} ms on the device), plain {plain_ms:.1f} ms (one "
        f"run), torch.bmm {lib_ms:.4f} ms (max |d| "
        f"{lib_err:.3g} against the kernel), bound {bound:.4f} ms "
        f"({bound_by}: {bytes_moved / 1e9:.3f} GB, {ops:.3e} ops), no-FMA "
        f"floor {ops / FP32_INSTR_PER_S * 1e3:.4f} ms ({ops:.3e} FP32 "
        f"instructions)")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms}


def linear_kernel_phase(dev):
    """B6 and B7 at the ingest (B = 3) and query-batch (B = 48) shapes, each
    at N = 1024 and 4096, and at B = 3, N = 10,240 (the lake's largest
    tables, about 10,000 rows); B8 at G = 6, Q in {16, 1}, P in {131,072,
    16,384} for CS (R = 5, W = 153) and JL (R = 1, W = 769), over real
    query tables and random corpus tables whose last 1,024 rows are
    spare."""
    from repro_torch.data.dataset_search import DatasetSearchIndex
    rng = np.random.default_rng(5)
    index = DatasetSearchIndex(m=M, seed=0, device=dev)
    sketch = {name: [linear_sketch_case(index, rng, name, B, nnz, dev)
                     for B in (3, 48) for nnz in (1000, 4000)]
              for name in ("cs", "jl")}
    for name, cases in sketch.items():
        cases.append(linear_sketch_case(
            index, np.random.default_rng((3, 10_000)), name, 3, 10_000, dev))
    estimate, tables_for = [], {}
    g = torch.Generator(device=dev).manual_seed(6)
    for name in ("cs", "jl"):
        fam = family_for(name)
        (tables,) = fam.sketch_rows(field_vectors(index, rng, 48, QUERY_ROWS),
                                    device=dev)
        tq = tables.reshape(16, 3, fam.reps, fam.width).transpose(0, 1)
        tc = torch.randn((3, EST_P, fam.reps, fam.width), device=dev,
                         generator=g)
        tc[:, -1024:] = 0.0
        estimate += [linear_estimate_case(name, tq[:, :q], tc[:, -p:])
                     for q, p in ((16, EST_P), (1, EST_P), (16, LAKE_TABLES),
                                  (1, LAKE_TABLES))]
        tables_for[name] = (tq, tc)
    return sketch, estimate, tables_for


def kernel_phase(dev):
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.kernels import icws_sketch as ks
    rng = np.random.default_rng(1)
    index = DatasetSearchIndex(m=M, seed=0, device=dev)
    sketch = [sketch_case(index, rng, B, nnz, dev)
              for B in (3, 48) for nnz in (1000, 4000)]

    # estimate: 16 queries' real sketch rows against P = 131,072 corpus rows
    # per field that copy a random query's samples with a per-row share and
    # draw the rest at random; the last 1,024 rows are spare (pad -2)
    keys_q = [rng.integers(0, KEY_DOMAIN, QUERY_ROWS) for _ in range(16)]
    vecs = [v for k in keys_q for v in index.vectorize(
        k, rng.normal(0.0, 1.0, k.size))]
    fp, val, _, _ = ks.icws_sketch_cuda(
        *[torch.from_numpy(a).to(dev) for a in pad_sparse_batch(vecs)[:3]],
        m=M, seed=0)
    fq = fp.reshape(16, 3, M).transpose(0, 1).contiguous()
    vq = val.reshape(16, 3, M).transpose(0, 1).contiguous()
    g = torch.Generator(device=dev).manual_seed(2)
    src = torch.randint(0, 16, (EST_P,), device=dev, generator=g)
    share = torch.rand((EST_P, 1), device=dev, generator=g) ** 3
    copy = torch.rand((3, EST_P, M), device=dev, generator=g) < share
    fc = torch.where(copy, fq[:, src], torch.randint(
        0, 2 ** 31 - 1, (3, EST_P, M), device=dev, generator=g,
        dtype=torch.int32))
    vc = torch.where(copy, vq[:, src] * 1.5,
                     torch.randn((3, EST_P, M), device=dev, generator=g) * 0.05)
    del copy
    fc[:, -1024:] = -2
    vc[:, -1024:] = 0.0
    # the batched launch at P = 131,072, then the shapes the service gives
    # the kernel: Q = 1 (`search`) and P = 16,384 (the lake's store
    # capacity), the latter over the last rows so that spare rows are in it
    estimate = [estimate_case(fq[:, :q], vq[:, :q], fc[:, -p:], vc[:, -p:])
                for q, p in ((16, EST_P), (1, EST_P), (16, LAKE_TABLES),
                             (1, LAKE_TABLES))]
    return sketch, estimate, (fq, vq, fc, vc)


def dmh_work(args, got, c: int):
    """The work one DMH launch's data needs, ``args = (w, keys, vals)``
    unreplicated and c replicas a key: live lanes, occupied bins, the
    densify probes each empty bin of a live row takes, their lane
    operations, and the bytes (every weight, the keys of live non-zeros,
    the winners' values, the four output planes)."""
    from repro_torch.kernels.common import (DMH_STREAM_BIN,
                                            DMH_STREAM_DENSIFY, as_u32,
                                            densify_probes, hash_u32,
                                            salt_for)
    dev = args[0].device
    live_nz = int((args[0] > 0).sum().item())
    t = torch.arange(M, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    occ = (hash_u32(as_u32(got[3]), salt_for(0, DMH_STREAM_BIN, zero)) % M
           == t) & (got[0] >= 0)
    J = densify_probes(M)
    j = torch.arange(J, device=dev)
    probe = hash_u32(t[:, None], salt_for(0, DMH_STREAM_DENSIFY, j)[None]) % M
    firstj = torch.where(occ[:, probe], j, J - 1).amin(2)
    need = ~occ & occ.any(1, keepdim=True)
    probes = int((firstj + 1)[need].sum().item())
    occupied = int(occ.sum().item())
    live = c * live_nz
    ops = (DMH_OPS_PER_LANE * live + DMH_OPS_PER_BIN * occupied
           + DMH_OPS_PER_PROBE * probes)
    bytes_moved = 4 * (args[0].numel() + live_nz + occupied) \
        + args[0].shape[0] * M * 16
    return live, occupied, probes, ops, bytes_moved


def dmh_sketch_case(index, rng, B: int, nnz: int, dev, b1=None):
    """One DMH launch at the path's shapes (B field rows of about ``nnz``
    non-zeros, each key's c = 4 replicas at m = 512 derived in the kernel)
    against its plain version: all four planes equal bit for bit.  Beside
    the bound, the issue floor (the live lanes' SASS instructions in the
    lane loop, one a lane and clock) and the launch's cluster and block;
    ``b1``, the ICWS sketch case at the same (B, nnz) where there is one,
    is printed beside."""
    from repro_torch.core.dmh import dmh_replication
    from repro_torch.kernels import dmh_sketch as kd
    args, c = padded_rows(index, rng, B, nnz, dev), dmh_replication(M)

    def kernel():
        return kd.dmh_sketch_cuda(*args, m=M, seed=0, replicas=c)
    got = kernel()
    torch.cuda.synchronize()
    want = kd.dmh_sketch_plain(*args, m=M, seed=0, replicas=c)
    n = args[0].shape[1]
    shape = f"B={B} N={n}x{c} m={M}"
    for name, i in (("fingerprints", 0), ("values", 1), ("amin", 2),
                    ("argkeys", 3)):
        if not bits_equal(got[i], want[i]):
            bad = int((got[i] != want[i]).sum().item())
            raise AssertionError(f"dmh sketch {shape}: {name} differ from "
                                 f"plain on {bad} slots")
    live, occupied, probes, ops, bytes_moved = dmh_work(args, got, c)
    bound, bound_by = bound_of(bytes_moved, ops)
    ms = time_ms(kernel, reps=20)
    names = []
    dev_ms, dev_src = device_ms(kernel, "dmh_sketch_kernel", names=names)
    plain = time_ms(lambda: kd.dmh_sketch_plain(*args, m=M, seed=0,
                                                replicas=c), reps=3, warmup=1)
    cluster, threads = kd._launch_shape(B, M, n * c)
    per_lane = unit_instructions("dmh_sketch_kernel", "ILb0E")
    floor = live * per_lane / FP32_INSTR_PER_S * 1e3 if per_lane else None
    log(f"dmh sketch {shape}: all four planes equal to plain; kernel "
        f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device, "
        f"{', '.join(names)}; clusters of {cluster} blocks of {threads} "
        f"threads), plain {plain:.3f} ms, bound {bound:.5f} ms ({bound_by}: "
        f"{live} live lanes, {occupied} occupied bins, {probes} densify "
        f"probes)" + (f", issue floor {floor:.5f} ms ({per_lane:g} SASS "
                      "instructions a lane)" if per_lane else "")
        + (f"; ICWS B1 at B={B} N={n}: {b1['device_ms']:.4f} ms on the "
           f"device, {b1['device_ms'] / dev_ms:.1f}x B5" if b1 else ""))
    return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src, "kernel": ", ".join(names),
            "cluster": cluster, "threads": threads,
            "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
            "instr_per_lane": per_lane, "floor_ms_issue": floor,
            "b1_device_ms": b1["device_ms"] if b1 else None}


# (B, non-zeros) of the B5 cases: the ingest (B = 3) and query-batch (B =
# 48) shapes at about 1,000 and 4,000 non-zeros (the B1 cases' shapes), and
# B = 3 at about 10,000 (the lake's largest tables)
DMH_SHAPES = ((3, 1000), (3, 4000), (48, 1000), (48, 4000), (3, 10_000))


def dmh_kernel_phase(dev, b1_cases):
    """B5 at ``DMH_SHAPES``, each through ``replicas = 4`` on unreplicated
    rows, as the ingest path calls it."""
    from repro_torch.data.dataset_search import DatasetSearchIndex
    rng = np.random.default_rng(1)
    index = DatasetSearchIndex(m=M, seed=0, device=dev)
    b1 = list(b1_cases) + [None] * (len(DMH_SHAPES) - len(b1_cases))
    return [dmh_sketch_case(index, rng, B, nnz, dev, b)
            for (B, nnz), b in zip(DMH_SHAPES, b1)]


def sample_work(kq, kc, hits, *, match_bytes: int, row_bytes: int = 0):
    """Lane operations, bytes and key matches of one key-match launch, as
    this run's data needs them: per (pair, query, row) the merge's steps
    over both live prefixes and the matches (``hits [6, Q, P]``); each used
    field's live corpus keys (and the key that ends a row's prefix) read
    once, ``match_bytes`` per corpus slot some query matches, ``row_bytes``
    per corpus row, the queries' live slots (key, value, probability) and
    the output."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    Q, P, S = kq.shape[1], kc.shape[1], kc.shape[2]
    live_q = (kq >= 0).sum(2).double()                 # [F, Q]
    live_c = (kc >= 0).sum(2).double()                 # [C, P]
    steps = sum(float(live_q[qf].sum()) * P + float(live_c[cf].sum()) * Q
                for qf, cf in zip(QFIELD, CFIELD))
    matches = float(hits.double().sum().item())
    ops = SAMPLE_OPS_PER_STEP * steps + SAMPLE_OPS_PER_MATCH * matches
    corpus_bytes = 0.0
    for cf in sorted(set(CFIELD)):
        qkeys = torch.cat([kq[qf][kq[qf] >= 0] for qf in
                           {qf for qf, c in zip(QFIELD, CFIELD) if c == cf}])
        matched = int(torch.isin(kc[cf], qkeys.unique()).sum().item())
        corpus_bytes += 4 * (float(live_c[cf].sum())
                             + int((live_c[cf] < S).sum().item())) \
            + match_bytes * matched + row_bytes * P
    bytes_moved = corpus_bytes + 12 * sum(
        float(live_q[qf].sum()) for qf in set(QFIELD)) \
        + 4 * len(QFIELD) * Q * P
    return ops, bytes_moved, matches


def sample_lookups(kq, kc):
    """Key lookups of one B9 / B13 launch at this data: for each block
    group of (query, pair) items (``sample_estimate.block_items``) and each
    corpus field its items read, ``CHUNK_STEPS`` a row and chunk (through
    the chunk that holds the row's first negative key)."""
    from repro_torch.data.dataset_search import CFIELD
    from repro_torch.kernels import sample_estimate as ks
    G, Q, S = len(CFIELD), kq.shape[1], kc.shape[2]
    chunk = ks.STEP_SLOTS * ks.CHUNK_STEPS
    steps = ks.CHUNK_STEPS * torch.clamp_max(
        (kc >= 0).sum(2) // chunk + 1, -(-S // chunk)).double().sum(1)  # [C]
    return sum(float(steps[cf]) for items in ks.block_items(G, Q, kq.shape[2])
               for cf in {CFIELD[g] for _, g in items})


def sample_floor(symbol: str, kq, kc):
    """(SASS instructions a lookup in the chunk loop, issue floor ms): a
    warp instruction per scheduler and clock on every SM."""
    per = unit_instructions(symbol, symbol)
    if per is None:
        return None, None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per, sample_lookups(kq, kc) * per / (4 * sms * sm_clock_hz()) \
        * 1e3


def sample_estimate_case(q, c, hits, *, check: bool):
    """One key-match launch: timed against its bound; with ``check`` also
    held bit for bit against its plain twin (the plain version on the
    corpus probabilities that the kernel computes from ``tc``).  ``hits
    [6, Q, P]`` counts the key matches of each (pair, query, row)."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import sample_estimate as ks
    kq, vq, aq = q
    kc, vc, tc = c
    G, Q, P, S = len(QFIELD), kq.shape[1], kc.shape[1], kq.shape[2]
    shape = f"G={G} Q={Q} P={P} S={S}"

    def kernel():
        return ks.sample_estimate_fields_cuda(kq, vq, aq, kc, vc, tc,
                                              qmap=QFIELD, cmap=CFIELD)
    got = kernel()
    torch.cuda.synchronize()
    err, plain_ms = None, None
    if check:
        t0 = time.perf_counter()
        want = ks.sample_estimate_fields_taus_plain(
            kq, vq, aq, kc, vc, tc, qmap=QFIELD, cmap=CFIELD)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max().item())
        if not bits_equal(got, want):
            raise AssertionError(f"sample estimate {shape}: kernel differs "
                                 f"from plain (max |d| {err})")
        if not bool(torch.isfinite(got).all()) or \
                int(torch.count_nonzero(got).item()) == 0:
            raise AssertionError(f"sample estimate {shape}: no finite "
                                 "non-zero estimate")
        del want
    ops, bytes_moved, matches = sample_work(kq, kc, hits, match_bytes=8)
    bound, bound_by = bound_of(bytes_moved, ops)
    ms = time_ms(kernel, reps=10)
    names = []
    dev_ms, dev_src = device_ms(kernel, "sample_estimate_fields_kernel",
                                names=names)
    per, floor = sample_floor("sample_estimate_fields_kernel", kq, kc)
    items, groups = ks.items_per_block(G, Q, S)
    log(f"sample estimate {shape}: "
        + (f"equal to plain (plain {plain_ms:.1f} ms, one run), " if check
           else "")
        + f"kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device, "
        f"{'; '.join(names) or 'no trace'}; {groups} groups of {items} "
        f"items), bound {bound:.4f} ms ({bound_by}: "
        f"{bytes_moved / 1e9:.3f} GB, {ops:.3e} ops, {matches:.0f} "
        "matches), issue floor "
        + (f"{floor:.4f} ms ({per:.1f} SASS instructions a lookup)"
           if per else "not counted"))
    return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src, "kernel": names,
            "groups": groups, "items_per_block": items,
            "instr_per_lookup": per, "floor_ms_issue": floor,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}


def sample_rows(dev):
    """16 queries' real TS rows (S = 768) and P = 131,072 synthetic corpus
    rows per field that copy a random query's live keys with a per-row
    share and fill the rest with fresh keys, sorted, cut to a random live
    length; the last 1,024 rows are spare.  Returns ((kq, vq, aq), tq,
    (kc, vc, tc))."""
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.kernels.sample_estimate import (sample_inclusion_probs,
                                                     sorted_prefix_ok)
    rng = np.random.default_rng(7)
    index = DatasetSearchIndex(m=M, seed=0, device=dev, family="ts")
    kq, vq, tq = index.family.sketch_rows(
        field_vectors(index, rng, 48, QUERY_ROWS), device=dev)
    S = kq.shape[1]
    kq, vq = (x.reshape(16, 3, S).transpose(0, 1).contiguous()
              for x in (kq, vq))
    tq = tq.reshape(16, 3).t().contiguous()
    aq = sample_inclusion_probs(vq, tq)

    g = torch.Generator(device=dev).manual_seed(8)
    P = EST_P
    src = torch.randint(0, 16, (P,), device=dev, generator=g)
    share = torch.rand((1, P, 1), device=dev, generator=g) ** 3
    copy = (torch.rand((3, P, S), device=dev, generator=g) < share) \
        & (kq[:, src] >= 0)
    fresh = KEY_DOMAIN + torch.arange(P, device=dev)[:, None] * S \
        + torch.arange(S, device=dev)
    kc = torch.where(copy, kq[:, src].long(), fresh)
    vc = torch.where(copy, vq[:, src] * 1.5, 0.05 + torch.rand(
        (3, P, S), device=dev, generator=g))
    del copy, fresh
    kc, order = torch.sort(kc, dim=2)
    vc = torch.gather(vc, 2, order)
    del order
    cut = torch.arange(S, device=dev) >= torch.randint(
        S // 8, S + 1, (3, P, 1), device=dev, generator=g)
    kc = torch.where(cut, -2, kc).int()
    vc = torch.where(cut, 0.0, vc)
    tc = torch.where(torch.rand((3, P), device=dev, generator=g) < 0.2, 0.0,
                     S * torch.rand((3, P), device=dev, generator=g))
    kc[:, -1024:], vc[:, -1024:], tc[:, -1024:] = -2, 0.0, 0.0
    del cut
    if not sorted_prefix_ok(kc):
        raise AssertionError("synthetic corpus rows break the sorted-prefix "
                             "contract")
    return (kq, vq, aq), tq, (kc, vc, tc)


def sample_kernel_phase(dev):
    """B9 over :func:`sample_rows`.  At the service's shape, Q in {16, 1}
    against the last 16,384 rows (the store's capacity on the lake, spare
    rows included), checked bit for bit against the plain version and
    timed; timed also at P = 131,072."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    q, _, (kc, vc, tc) = sample_rows(dev)
    kq, P = q[0], kc.shape[1]
    # key matches per (pair, query, corpus row), for the bound
    hits = torch.zeros((len(QFIELD), 16, P), dtype=torch.int32, device=dev)
    for gi, (qf, cf) in enumerate(zip(QFIELD, CFIELD)):
        for qi in range(16):
            live = kq[qf, qi][kq[qf, qi] >= 0]
            hits[gi, qi] = torch.isin(kc[cf], live).sum(1)
    torch.cuda.empty_cache()
    checked = [sample_estimate_case(tuple(x[:, :qn] for x in q),
                                    tuple(x[:, -p:] for x in (kc, vc, tc)),
                                    hits[:, :qn, -p:], check=p < EST_P)
               for qn, p in ((16, LAKE_TABLES), (1, LAKE_TABLES),
                             (16, EST_P), (1, EST_P))]
    return checked, (q, (kc, vc, tc), hits[:, :, -LAKE_TABLES:])


def small_reference_phase(dev, family: str):
    """The service on the card against the same service on the CPU (plain
    kernels) on a small lake: same rankings, estimates within f32 tolerance."""
    from repro_torch import SketchSearchService
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 5_000, 800)
    signal = rng.normal(size=800)
    tables = [("corr", keys, 2 * signal + 0.1 * rng.normal(size=800)),
              ("noise", keys, rng.normal(size=800)),
              ("half", np.concatenate([keys[:400], rng.integers(0, 5_000, 400)]),
               rng.normal(size=800))]
    tables += [(f"r{i}", rng.integers(0, 5_000, 300), rng.normal(size=300))
               for i in range(9)]
    queries = [(keys, signal), (keys[:500], rng.normal(size=500))]
    out = []
    for device in ("cpu", dev):
        svc = SketchSearchService(m=M, seed=0, family=family,
                                  keep_host_oracle=False, device=device)
        svc.ingest_many(tables)
        out.append(svc.search_batch(queries, top_k=5, min_join=20,
                                    micro_batch=2))
    for a, b in zip(*out):
        if [r.name for r in a] != [r.name for r in b]:
            raise AssertionError(f"card ranking {[r.name for r in b]} != "
                                 f"cpu ranking {[r.name for r in a]}")
        for x, y in zip(a, b):
            if not (math.isfinite(y.join_size) and math.isfinite(y.sum_b)):
                raise AssertionError("non-finite estimate on the card")
            if abs(x.join_size - y.join_size) > 1e-4 * max(1.0, abs(x.join_size)):
                raise AssertionError(f"join size {y.join_size} != {x.join_size}")
    if out[1][0][0].name != "corr":
        raise AssertionError(f"small lake ({family}): top hit "
                             f"{out[1][0][0].name}")
    log(f"small lake ({family}): card ranking equals the cpu ranking "
        f"{[r.name for r in out[1][0]]}")


def bits_equal(a, b) -> bool:
    """Whether two 32-bit tensors hold the same bits (so -0.0 != +0.0 and
    a NaN equals its own bits)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def bound_of(bytes_moved: float, ops: float):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and lane operations over the FP32 rate."""
    bound_b, bound_o = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(bound_b, bound_o) * 1e3,
            "bytes" if bound_b >= bound_o else "operations")


def b10_case(index, rng, kind: str, B: int, nnz: int, dev):
    """B10, the pack epilogue of the ICWS or DMH sketch, at a sketch shape:
    its four planes equal the unpacked kernel's and its packed plane the
    codec of that kernel's values, bit for bit; against the plain version,
    every word whose two fingerprints agree equal (ICWS: at least 99% of
    words, as B1; DMH: all)."""
    from repro_torch.core.dmh import dmh_replication
    from repro_torch.kernels import dmh_sketch, icws_sketch
    from repro_torch.kernels.packed import pack_sketch_vals
    args, c = padded_rows(index, rng, B, nnz, dev), dmh_replication(M)
    n = args[0].shape[1]
    if kind == "dmh":   # c replicas a key, derived in the kernel
        shape, mod, kw = f"B={B} N={n}x{c} m={M}", dmh_sketch, {"replicas": c}
    else:
        shape, mod, kw = f"B={B} N={n} m={M}", icws_sketch, {}
    kernel = functools.partial(getattr(mod, f"{kind}_sketch_packed_cuda"),
                               m=M, seed=0, **kw)
    plain = functools.partial(getattr(mod, f"{kind}_sketch_packed_plain"),
                              m=M, seed=0, **kw)
    got = kernel(*args)
    base = getattr(mod, f"{kind}_sketch_cuda")(*args, m=M, seed=0, **kw)
    torch.cuda.synchronize()
    if not (all(bits_equal(x, y) for x, y in zip(got[:4], base))
            and torch.equal(got[4], pack_sketch_vals(base[1], base[2]))):
        raise AssertionError(f"{kind} sketch packed {shape}: differs from "
                             "the unpacked kernel and the codec of its values")
    want = plain(*args)
    ok = (got[0] == want[0]).reshape(B, M // 2, 2).all(2)
    share = ok.float().mean().item()
    if share < (0.99 if kind == "icws" else 1.0) \
            or not torch.equal(got[4][ok], want[4][ok]):
        raise AssertionError(f"{kind} sketch packed {shape}: packed plane "
                             f"differs from plain (words agreeing {share})")
    if kind == "icws":
        _, ops, bytes_moved = icws_work(args)
    else:
        *_, ops, bytes_moved = dmh_work(args, got, c)
    bound, bound_by = bound_of(bytes_moved + B * M * 2, ops)
    ms = time_ms(lambda: kernel(*args), reps=20)
    dev_ms, dev_src = device_ms(lambda: kernel(*args), f"{kind}_sketch_kernel")
    plain_ms = time_ms(lambda: plain(*args), reps=3, warmup=1)
    log(f"{kind} sketch packed {shape}: planes equal to the unpacked "
        f"kernel's, packed plane its codec, equal to plain on {share:.6f} of "
        f"words; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the "
        f"device), plain {plain_ms:.3f} ms, bound {bound:.5f} ms ({bound_by})")
    extra = {"group_size": icws_sketch._group_size(B, M, n)} \
        if kind == "icws" else {}
    return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "words_agree": share, **extra}


def packed_estimate_case(fq, vq, fc, wc):
    """B11 against its plain version and against B2 on the decoded corpus,
    bit for bit."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import estimate as ke
    from repro_torch.kernels.packed import unpack_halfwords_f32
    G, Q, P = len(QFIELD), fq.shape[1], fc.shape[1]
    shape = f"G={G} Q={Q} P={P} m={M}"

    def kernel():
        return ke.estimate_fields_packed_cuda(fq, vq, fc, wc, qmap=QFIELD,
                                              cmap=CFIELD)
    got = kernel()
    b2 = ke.estimate_fields_cuda(fq, vq, fc, unpack_halfwords_f32(wc),
                                 qmap=QFIELD, cmap=CFIELD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ke.estimate_fields_packed_plain(fq, vq, fc, wc, qmap=QFIELD,
                                            cmap=CFIELD)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for name, want in (("plain", plain), ("B2 on the decoded corpus", b2)):
        if not (bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])):
            raise AssertionError(f"packed estimate {shape}: differs from "
                                 f"{name}")
    hits = float(got[0].double().sum().item())
    ops = EST_OPS_PER_TEST * G * Q * P * M + EST_OPS_PER_HIT * hits
    bytes_moved = (fq.numel() + vq.numel() + fc.numel() + wc.numel()) * 4 \
        + 2 * G * Q * P * 4
    bound, bound_by = bound_of(bytes_moved, ops)
    ms = time_ms(kernel, reps=10)
    names = []
    dev_ms, dev_src = device_ms(kernel, "estimate_fields_packed_kernel",
                                names=names)
    log(f"packed estimate {shape}: equal to plain and to B2 on the decoded "
        f"corpus; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the "
        f"device, {', '.join(names)}), plain {plain_ms:.1f} ms (one run), "
        f"bound {bound:.4f} ms ({bound_by}: {bytes_moved / 1e9:.3f} GB)")
    return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src, "kernel": ", ".join(names),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}


def packed_linear_case(name: str, tq, wc):
    """B12 against its plain version and against B8 on the decoded tables
    (over the true W), bit for bit; ``torch.bmm`` in f32 over the decoded,
    (pair, rep)-gathered tables as the library call."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import estimate as ke
    from repro_torch.kernels.packed import unpack_halfwords_f32
    G, (Q, R, W), P = len(QFIELD), tq.shape[1:], wc.shape[1]
    We = 2 * wc.shape[3]
    tqe = torch.nn.functional.pad(tq, (0, We - W)).contiguous()
    shape = f"{name} G={G} R={R} Q={Q} P={P} W={W}"

    def kernel():
        return ke.linear_estimate_fields_packed_cuda(tqe, wc, qmap=QFIELD,
                                                     cmap=CFIELD)
    got = kernel()
    tc = unpack_halfwords_f32(wc)
    b8 = ke.linear_estimate_fields_cuda(tq, tc[..., :W].contiguous(),
                                        qmap=QFIELD, cmap=CFIELD)
    torch.cuda.synchronize()
    plain_ms = time_ms(lambda: ke.linear_estimate_fields_packed_plain(
        tqe, wc, qmap=QFIELD, cmap=CFIELD), reps=1, warmup=0)
    plain = ke.linear_estimate_fields_packed_plain(tqe, wc, qmap=QFIELD,
                                                   cmap=CFIELD)
    if not (bits_equal(got, plain) and bits_equal(got, b8)):
        raise AssertionError(f"packed linear estimate {shape}: differs from "
                             "plain or from B8 on the decoded tables")
    del plain, b8
    a = torch.stack([tqe[qf] for qf in QFIELD]).permute(0, 2, 1, 3).reshape(
        G * R, Q, We).contiguous()
    b = torch.stack([tc[cf] for cf in CFIELD]).permute(0, 2, 1, 3).reshape(
        G * R, P, We).contiguous()
    del tc
    lib_ms = time_ms(lambda: torch.bmm(a, b.transpose(1, 2)), reps=10)
    del a, b
    # the pad column's +0 products are no work the estimate needs: the
    # operations count the true W
    ops = 2 * G * R * Q * P * W
    bound, bound_by = bound_of(
        (tq.numel() + wc.numel() + got.numel()) * 4, ops)
    ms = time_ms(kernel, reps=10)
    dev_ms, dev_src = device_ms(kernel, "linear_estimate_fields_packed_kernel")
    log(f"packed linear estimate {shape}: equal to plain and to B8 on the "
        f"decoded tables; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on "
        f"the device), plain {plain_ms:.1f} ms (one run), torch.bmm "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}), no-FMA floor "
        f"{ops / FP32_INSTR_PER_S * 1e3:.4f} ms ({ops:.3e} FP32 "
        f"instructions)")
    return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms}


def packed_sample_case(q, c, hits, *, check: bool):
    """B13 against B9 on the decoded corpus (values and taus) and, with
    ``check``, against its plain version, bit for bit."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import sample_estimate as ks
    from repro_torch.kernels.packed import unpack_halfwords_f32
    kq, vq, aq = q
    kc, wc, tc = c
    G, Q, P, S = len(QFIELD), kq.shape[1], kc.shape[1], kq.shape[2]
    shape = f"G={G} Q={Q} P={P} S={S}"

    def kernel():
        return ks.sample_estimate_fields_packed_cuda(kq, vq, aq, kc, wc, tc,
                                                     qmap=QFIELD, cmap=CFIELD)
    got = kernel()
    b9 = ks.sample_estimate_fields_cuda(kq, vq, aq, kc,
                                        unpack_halfwords_f32(wc), tc,
                                        qmap=QFIELD, cmap=CFIELD)
    torch.cuda.synchronize()
    if not bits_equal(got, b9) or int(torch.count_nonzero(got).item()) == 0:
        raise AssertionError(f"packed sample estimate {shape}: differs from "
                             "B9 on the decoded corpus, or all zero")
    plain_ms = None
    if check:
        t0 = time.perf_counter()
        plain = ks.sample_estimate_fields_packed_plain(
            kq, vq, aq, kc, wc, tc, qmap=QFIELD, cmap=CFIELD)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not bits_equal(got, plain):
            raise AssertionError(f"packed sample estimate {shape}: differs "
                                 "from plain")
    ops, bytes_moved, matches = sample_work(kq, kc, hits, match_bytes=2,
                                            row_bytes=4)
    bound, bound_by = bound_of(bytes_moved, ops)
    ms = time_ms(kernel, reps=10)
    names = []
    dev_ms, dev_src = device_ms(kernel, "sample_estimate_fields_packed_kernel",
                                names=names)
    per, floor = sample_floor("sample_estimate_fields_packed_kernel", kq, kc)
    items, groups = ks.items_per_block(G, Q, S)
    log(f"packed sample estimate {shape}: equal to B9 on the decoded corpus"
        + (f" and to plain (plain {plain_ms:.1f} ms, one run)" if check
           else "")
        + f"; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device, "
        f"{'; '.join(names) or 'no trace'}; {groups} groups of {items} "
        f"items), bound {bound:.4f} ms ({bound_by}: "
        f"{bytes_moved / 1e9:.3f} GB, {ops:.3e} ops, {matches:.0f} "
        "matches), issue floor "
        + (f"{floor:.4f} ms ({per:.1f} SASS instructions a lookup)"
           if per else "not counted"))
    return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": dev_src, "kernel": names,
            "groups": groups, "items_per_block": items,
            "instr_per_lookup": per, "floor_ms_issue": floor,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}


def packed_kernel_phase(dev, icws_data, lin_data, sample_data):
    """B10 at the sketch shapes B = 3, N = 1,024 and B = 48, N = 4,096 (ICWS
    and DMH); B11 at G = 6, Q = 16, P = 131,072, Q = 1, P = 16,384 (`search`)
    and Q = 16, P = 16,384 (the micro-batch); B12 at the first two for CS
    and JL; B13 at the service's shape, Q = 16 and 1 against
    the last 16,384 rows (spare rows included), each held against B9 on
    the decoded corpus and against its plain version.  The corpora are the
    unpacked kernel phases', packed."""
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.kernels.packed import pack_halfwords_f32
    rng = np.random.default_rng(10)
    index = DatasetSearchIndex(m=M, seed=0, device=dev)
    b10 = {kind: [b10_case(index, rng, kind, B, nnz, dev)
                  for B, nnz in ((3, 1000), (48, 4000))]
           for kind in ("icws", "dmh")}
    shapes = ((16, EST_P), (1, LAKE_TABLES))
    fq, vq, fc, vc = icws_data
    wc = pack_halfwords_f32(vc)
    b11 = [packed_estimate_case(fq[:, :q], vq[:, :q], fc[:, -p:], wc[:, -p:])
           for q, p in shapes + ((16, LAKE_TABLES),)]
    b12 = []
    for name in ("cs", "jl"):
        tq, tc = lin_data[name]
        wc = pack_halfwords_f32(torch.nn.functional.pad(tc, (0, tc.shape[3] % 2)))
        b12 += [packed_linear_case(name, tq[:, :q], wc[:, -p:])
                for q, p in shapes]
    q, (kc, vc, tc), hits = sample_data
    c = (kc[:, -LAKE_TABLES:], pack_halfwords_f32(vc[:, -LAKE_TABLES:]),
         tc[:, -LAKE_TABLES:])
    b13 = [packed_sample_case(tuple(x[:, :qn] for x in q), c, hits[:, :qn],
                              check=True) for qn in (16, 1)]
    return b10, b11, b12, b13


def pair_case(label, kernel, plain, args, *, tests, bytes_moved, symbol):
    """One B3 or B4 launch at the corpus path's width against its plain
    version, bit for bit; timed against its bound (bytes: every input read
    once, the two outputs written once; operations: 2 per test and 8 per
    collision of this data).  Returns (report, the kernel's output)."""
    got = kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not (bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])):
        raise AssertionError(f"{label}: kernel differs from plain")
    del want
    hits = float(got[0].double().sum().item())
    bound, bound_by = bound_of(bytes_moved, EST_OPS_PER_TEST * tests
                               + EST_OPS_PER_HIT * hits)
    ms = time_ms(lambda: kernel(*args), reps=10)
    names = []
    dev_ms, dev_src = device_ms(lambda: kernel(*args), symbol, names=names)
    log(f"{label}: equal to plain, {hits:.0f} collisions of {tests} tests; "
        f"kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device, "
        f"{', '.join(names)}), plain {plain_ms:.1f} ms (one run), bound "
        f"{bound:.4f} ms ({bound_by}: {bytes_moved / 1e9:.3f} GB)")
    return ({"shape": label.split(" ", 1)[1], "max_abs_err": 0.0, "ms": ms,
             "device_ms": dev_ms, "device_ms_source": dev_src,
             "kernel": ", ".join(names), "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": bound_by}, got)


def corpus_kernel_phase(icws_data):
    """B3 (pairwise, one-vs-many) and B4 (Q = 16 and 1) at m = 512 against
    P = 131,072 rows: field 0 of the icws kernel phase's corpus (rows that
    copy a query's samples with a per-row share, the last 1,024 spare),
    each against its plain version bit for bit, B3 one-vs-many also at the
    corpus path's P (its last CORPUS_P rows); then, on the card, row 0 of
    B4 at Q = 1, the one-vs-many route, the pairwise route on query 0 tiled
    to P rows and B2 with qmap = cmap = (0,) give the same bits, and B4 at
    Q = 16 equals B2 at G = 1 on those 16 queries."""
    from repro_torch.kernels import estimate as ke
    fq, vq, fc, vc = icws_data
    fq, vq, fc, vc = fq[0], vq[0], fc[0], vc[0]
    P = fc.shape[0]
    plane = P * M * 8
    ta = fq[0].expand(P, M).contiguous()
    tv = vq[0].expand(P, M).contiguous()
    pairs, got_p = pair_case(
        f"B3 pairwise P={P} m={M}", ke.estimate_partials_cuda,
        ke.estimate_partials_plain, (ta, tv, fc, vc), tests=P * M,
        bytes_moved=2 * plane + 2 * P * 4, symbol="estimate_pairs_kernel")
    del ta, tv
    ones = [pair_case(
        f"B3 one-vs-many P={p} m={M}", ke.estimate_one_vs_many_cuda,
        ke.estimate_one_vs_many_plain, (fq[0], vq[0], fc[-p:], vc[-p:]),
        tests=p * M, bytes_moved=M * 8 + p * M * 8 + 2 * p * 4,
        symbol="estimate_one_vs_many_kernel") for p in (P, CORPUS_P)]
    one, got_1 = [r for r, _ in ones], ones[0][1]
    if not all(bits_equal(ones[1][1][i], got_1[i][-CORPUS_P:])
               for i in range(2)):
        raise AssertionError("B3 one-vs-many: a row's sums depend on P")
    del ones
    many, got = [], {}
    for q in (16, 1):
        rep, got[q] = pair_case(
            f"B4 Q={q} P={P} m={M}", ke.estimate_many_vs_many_cuda,
            ke.estimate_many_vs_many_plain, (fq[:q], vq[:q], fc, vc),
            tests=q * P * M, bytes_moved=q * M * 8 + plane + 2 * q * P * 4,
            symbol="estimate_many_kernel")
        many.append(rep)
    b2 = ke.estimate_fields_cuda(fq[None, :16], vq[None, :16], fc[None],
                                 vc[None], qmap=(0,), cmap=(0,))
    torch.cuda.synchronize()
    for i in range(2):
        if not bits_equal(got[16][i], b2[i][0]):
            raise AssertionError("B4 at Q = 16 differs from B2 at G = 1")
        if not all(bits_equal(got[1][i][0], x) for x in (
                got_1[i], got_p[i], b2[i][0, 0])):
            raise AssertionError("B4 row 0, B3 one-vs-many, B3 pairwise on "
                                 "the tiled query and B2 at G = 1 differ")
    log(f"B4 at Q=16 == B2 at qmap=cmap=(0,); B4 row 0 (Q=1) == B3 "
        f"one-vs-many == B3 pairwise on the tiled query == B2's row 0, bit "
        f"for bit, P={P} m={M}")
    return pairs, one, many


def corpus_phase(lake):
    """The corpus path: ``SketchCorpus(m=512)`` on the card ingests every
    field vector of the lake (vectorized as the service does it) through
    ``add_batch`` in batches of 48, answers the first field vector of each
    of the 64 queries with ``estimate_vec`` one at a time and with
    ``estimate_vecs`` in 4 batches of 16 (bit for bit equal), then pulls
    1,024 rows (the 32 planted partners' among them) and the queries back
    with ``arrays()``: the card's estimates there are held against the
    host ICWS estimator in f64 (< 10 ppm, ``perf_sketch.py``'s gate) and
    ``ops.icws_estimate`` on those (query, row) pairs against them bit for
    bit.  Counters set to 0 just before the ingest and read just after the
    pairwise estimate.  Returns the launches."""
    from repro_torch import SketchCorpus
    from repro_torch.core import ICWS, StackedICWS
    from repro_torch.data.dataset_search import DatasetSearchIndex
    from repro_torch.data.ingest import sketch_batch
    from repro_torch.kernels import ops
    tables, queries, partners = lake
    index = DatasetSearchIndex(m=M, seed=0)
    t0 = time.perf_counter()
    vecs = [v for _, k, x in tables for v in index.vectorize(k, x)]
    qvecs = [index.vectorize(k, x)[0] for k, x in queries]
    log(f"corpus: {len(vecs)} field vectors of {len(tables)} tables and "
        f"{len(qvecs)} query vectors vectorized in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    corpus = SketchCorpus(m=M, seed=0)
    counters = reset_counters()
    t0 = time.perf_counter()
    for lo in range(0, len(vecs), CORPUS_BATCH):
        corpus.add_batch(vecs[lo:lo + CORPUS_BATCH])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    seq, one_ms = [], []
    for v in qvecs:
        t0 = time.perf_counter()
        seq.append(corpus.estimate_vec(v))
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    batched, batch_ms = [], []
    for lo in range(0, len(qvecs), MICRO_BATCH):
        t0 = time.perf_counter()
        batched.append(corpus.estimate_vecs(qvecs[lo:lo + MICRO_BATCH]))
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    seq, batched = torch.stack(seq), torch.cat(batched)
    n = len(corpus)
    if seq.shape != (QUERIES, n) or not bits_equal(batched, seq):
        raise AssertionError("corpus: estimate_vecs differs from estimate_vec")
    if not bool(torch.isfinite(seq).all()):
        raise AssertionError("corpus: non-finite estimate")

    pos = {name: i for i, (name, _, _) in enumerate(tables)}
    partner_rows = np.array([3 * pos[p] for p in partners if p is not None])
    others = np.setdiff1d(np.arange(0, n, 47), partner_rows)
    rows = np.sort(np.concatenate(
        [partner_rows, others[:CORPUS_HOST_ROWS - partner_rows.size]]))
    fpc, vc, nc, _ = corpus.arrays()
    ri = torch.from_numpy(rows).to(fpc.device)
    fq, vq, nq, _ = sketch_batch(qvecs, m=M, seed=0, device=fpc.device)
    qi = torch.arange(QUERIES, device=fpc.device).repeat_interleave(ri.numel())
    pair_est = ops.icws_estimate(fq[qi], vq[qi], nq[qi], fpc[ri.repeat(
        QUERIES)], vc[ri.repeat(QUERIES)], nc[ri.repeat(QUERIES)])
    torch.cuda.synchronize()
    launches = {k: counters[k].launches for k in CORPUS_KERNELS}
    card = seq[:, ri]
    if not bits_equal(pair_est.reshape(QUERIES, -1), card):
        raise AssertionError("corpus: ops.icws_estimate on (query, row) pairs "
                             "differs from the corpus estimates")
    rows_h = StackedICWS(fingerprints=fpc[ri].cpu().numpy(),
                         values=vc[ri].cpu().numpy().astype(np.float64),
                         norm=nc[ri].cpu().numpy().astype(np.float64))
    fq_h, vq_h, nq_h = (x.cpu().numpy() for x in (fq, vq, nq))
    host = np.stack([ICWS(m=M, seed=0).estimate_batch(StackedICWS(
        fingerprints=np.repeat(fq_h[q:q + 1], rows.size, 0),
        values=np.repeat(vq_h[q:q + 1].astype(np.float64), rows.size, 0),
        norm=np.full(rows.size, float(nq_h[q]))), rows_h)
        for q in range(QUERIES)])
    dev64 = card.cpu().numpy().astype(np.float64)
    scale = np.maximum(np.maximum(np.abs(host), np.abs(dev64)), 1e-12)
    rel_ppm = float(np.max(np.abs(dev64 - host) / scale)) * 1e6
    live = int(np.count_nonzero(host))
    if rel_ppm >= 10.0 or live == 0:
        raise AssertionError(f"corpus: card vs host ICWS estimator "
                             f"{rel_ppm:.3f} ppm (gate 10), {live} non-zero")
    # each query against the tables' first field (rows 0, 3, 6, ...)
    top = seq[:QUERIES // 2, 0::3].argmax(1).cpu().numpy()
    found = int(sum(t == pos[p] for t, p in zip(top, partners)))
    need = {"icws_sketch": math.ceil(n / CORPUS_BATCH) + QUERIES
            + QUERIES // MICRO_BATCH + 1, "estimate_pairs": 1,
            "estimate_one_vs_many": QUERIES,
            "estimate_many": QUERIES // MICRO_BATCH}
    if corpus.capacity != CORPUS_P:
        raise AssertionError(f"corpus: capacity {corpus.capacity}, the "
                             f"corpus kernel phase timed P = {CORPUS_P}")
    log(f"corpus: {n} rows (capacity {corpus.capacity}), "
        f"{corpus._store.bytes_per_row()} B per row, "
        f"{corpus.capacity * corpus._store.bytes_per_row() / 1e6:.1f} MB "
        f"resident; ingest {n / ingest_s:.1f} vectors/s ({ingest_s:.1f} s, "
        f"add_batch of {CORPUS_BATCH}); estimate_vec p50 "
        f"{statistics.median(one_ms):.3f} ms ({len(one_ms)}), estimate_vecs "
        f"p50 {statistics.median(batch_ms):.3f} ms ({len(batch_ms)} batches "
        f"of {MICRO_BATCH}); estimate_vecs == estimate_vec bit for bit; card "
        f"vs host ICWS estimator on {rows.size} rows x {QUERIES} queries: max "
        f"{rel_ppm:.4f} ppm ({live} non-zero), ops.icws_estimate on those "
        f"pairs equal bit for bit; planted partner ranked first among the "
        f"tables' first fields for {found} of {QUERIES // 2} queries; "
        f"launches {launches} on {card_identity()}")
    if any(launches[k] < v for k, v in need.items()):
        raise AssertionError(f"corpus: launches {launches} below {need}")
    sharded = sharded_corpus_check(corpus, qvecs, batched)
    del corpus
    gc.collect()
    torch.cuda.empty_cache()
    return launches, sharded


def sharded_corpus_check(corpus, qvecs, want):
    """``SketchCorpus(mesh=...)`` over the corpus's rows
    (``convert.corpus_from_numpy``: no second ingest), split over
    ``SHARDS[0]`` shards of the card: ``estimate_vecs`` of the query
    vectors in batches of 16 equals the unsharded corpus's (``want``) bit
    for bit, B4 launched once a shard a batch.  Counters set to 0 just
    before the queries and read just after.  Returns the launches."""
    from repro_torch.convert import corpus_from_numpy
    mesh = cuda_mesh(SHARDS[0])
    sharded = corpus_from_numpy(*(a.cpu().numpy() for a in corpus.arrays()),
                                m=M, seed=0, mesh=mesh)
    counters = reset_counters()
    got = torch.cat([sharded.estimate_vecs(qvecs[lo:lo + MICRO_BATCH])
                     for lo in range(0, len(qvecs), MICRO_BATCH)])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    batches = math.ceil(len(qvecs) / MICRO_BATCH)
    if not bits_equal(got, want):
        raise AssertionError("corpus: the sharded estimate_vecs differ from "
                             "the unsharded corpus's")
    if launches["estimate_many"] != SHARDS[0] * batches:
        raise AssertionError(f"corpus: the sharded corpus launched B4 "
                             f"{launches['estimate_many']} times")
    log(f"corpus sharded over {SHARDS[0]} shards of "
        f"{sharded.capacity // SHARDS[0]} rows on cuda:0: estimate_vecs "
        f"({batches} batches of {MICRO_BATCH}) == the unsharded corpus's bit "
        f"for bit; B4 launched {launches['estimate_many']} times")
    return launches


def norm_epilogue_phase():
    """The ICWS norm epilogue (``ops._norm_epilogue``) on the card against
    the same call on the cpu, bit for bit, at every count 0..m for m = 266
    and 512, with random norms (some zero) and partial sums."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(32)
    for m in (266, M):
        cnt = torch.arange(m + 1, dtype=torch.float32)
        sw, na, nb = (torch.from_numpy(x.astype(np.float32)) for x in (
            rng.normal(size=m + 1), 10 * rng.random(m + 1),
            rng.random(m + 1)))
        nb[::7] = 0.0
        want = ops._norm_epilogue(cnt, sw, na, nb, m)
        got = ops._norm_epilogue(*(x.cuda() for x in (cnt, sw, na, nb)), m)
        if not bits_equal(got.cpu(), want):
            raise AssertionError(f"norm epilogue at m = {m}: the card's bits "
                                 "differ from the cpu's")
    log("norm epilogue: the card equals the cpu bit for bit at every count "
        "0..m, m = 266 and 512")


def compression_kernel_phase():
    """B14 at one TinyLlama-1.1B layer's gradient (T = 44,044,288, W =
    4096, R = 5, seed 17) against its plain version bit for bit, and at
    T = L (one chunk) against B6 on keys ``o + arange(L)``, both the
    kernels and the plain versions; timed against its bound (bytes: x read
    once, the table written once; operations: 46 per (element, rep)) and
    its issue floor (the SASS instructions a term of the partial kernel's
    sub-chunk loop, one a lane and clock; the loops over a bucket's run
    nested in it are not counted)."""
    from repro_torch.kernels import countsketch as kcs
    from repro_torch.optim.compression import CompressionConfig
    cfg = CompressionConfig()
    kw = dict(width=cfg.width, reps=cfg.reps, seed=cfg.seed)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_t(3, GRAD_T).astype(np.float32)).cuda()
    reports = []
    L, off = kcs.DENSE_CHUNK, 1 << 20
    for label, xs, offset in ((f"T={GRAD_T} W={cfg.width} R={cfg.reps}", x,
                               0),
                              (f"T=L={L} W={cfg.width} R={cfg.reps}", x[:L],
                               off)):
        fn = functools.partial(kcs.countsketch_dense_cuda, xs, **kw,
                               offset=offset)
        got = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kcs.countsketch_dense_plain(xs, **kw, offset=offset)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not bits_equal(got, want):
            raise AssertionError(f"B14 {label}: kernel differs from plain")
        T = xs.shape[0]
        bound, bound_by = bound_of(4 * T + 4 * cfg.reps * cfg.width,
                                   CS_OPS_PER_TERM * T * cfg.reps)
        ms = time_ms(fn, reps=10)
        dev_ms, dev_src = device_ms(
            fn, tuple(f"countsketch_dense_{k}" for k in (
                ("partial", "reduce") if T > L else ("partial",))))
        symbol = "countsketch_dense_partial_kernel"
        per_term = unit_instructions(symbol, symbol)
        floor_issue = (T * cfg.reps * per_term / FP32_INSTR_PER_S * 1e3
                       if per_term else None)
        log(f"B14 {label}: equal to plain; kernel {ms:.4f} ms per call "
            f"({dev_ms:.4f} ms on the device), plain {plain_ms:.1f} ms (one "
            f"run), bound {bound:.4f} ms ({bound_by})"
            + (f", issue floor {floor_issue:.4f} ms ({per_term:g} SASS "
               "instructions a term)" if per_term else ""))
        reports.append({"shape": label, "max_abs_err": 0.0, "ms": ms,
                        "device_ms": dev_ms, "device_ms_source": dev_src,
                        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": None, "instr_per_term": per_term,
                        "floor_ms_issue": floor_issue})
    keys = (off + torch.arange(L, dtype=torch.int32, device="cuda"))[None]
    b6 = kcs.countsketch_sparse_cuda(keys, x[None, :L], **kw)[0]
    b6_plain = kcs.countsketch_sparse_plain(keys, x[None, :L], **kw)[0]
    if not (bits_equal(got, b6) and bits_equal(want, b6_plain)):
        raise AssertionError("B14 at T = L differs from B6 on keys o + arange(L)")
    log(f"B14 at T = L = {L}, offset {off} == B6 on keys offset + arange(L), "
        f"kernels and plain versions, bit for bit")
    return reports


def compression_phase():
    """The gradient-compression path: ``compressed_update`` with
    ``CompressionConfig``'s defaults on the card, COMPRESS_STEPS steps of EF-SGD on the quadratic
    ``|x - target|^2 / 2`` at one TinyLlama-1.1B layer's size, the target
    heavy-tailed (65,536 coordinates t(2)-distributed, times 3, over
    N(0, 0.01^2) noise).  B14's counter is set to 0 just before the steps
    and read just after.  Returns its launches."""
    from repro_torch.kernels.countsketch import countsketch_dense_cuda
    from repro_torch.optim.compression import (CompressionConfig,
                                               compressed_update)
    cfg = CompressionConfig()
    target = compression_target()
    x = torch.zeros_like(target)
    residual = torch.zeros_like(target)
    torch.cuda.synchronize()
    countsketch_dense_cuda.launches = 0
    steps = []
    for _ in range(COMPRESS_STEPS):
        t0 = time.perf_counter()
        delta, residual = compressed_update(x - target, residual, None, cfg,
                                            lr=0.3)
        x = x - delta
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    launches = countsketch_dense_cuda.launches
    rel = float(torch.linalg.vector_norm(x - target)
                / torch.linalg.vector_norm(target))
    log(f"compression: {COMPRESS_STEPS} compressed_update steps of "
        f"T={GRAD_T}, width {cfg.width}, reps {cfg.reps}; B14 launches "
        f"{launches}; relative error to the target {rel:.6f} (1 at the "
        f"start); ms per step " + ", ".join(f"{t:.1f}" for t in steps))
    if launches != COMPRESS_STEPS or not 0.0 < rel < 1.0:
        raise AssertionError(f"compression path: {launches} B14 launches, "
                             f"relative error {rel}")
    return launches


def compression_target() -> torch.Tensor:
    """The compression path's target on the card: N(0, 0.01^2) over
    ``GRAD_T`` coordinates, 65,536 of them t(2) x 3 heavier."""
    rng = np.random.default_rng(18)
    target = 0.01 * rng.standard_normal(GRAD_T, dtype=np.float32)
    heavy = np.unique(rng.integers(0, GRAD_T, 65_536))
    target[heavy] += 3 * rng.standard_t(2, heavy.size).astype(np.float32)
    return torch.from_numpy(target).cuda()


def compression_axis_phase():
    """``compressed_update(axis_name="data")`` over a 1-rank NCCL group
    (rendezvous through a ``file://`` store in a temporary directory; the
    world group registered with ``launch.register_world_axis``) against
    ``axis_name=None``: 2 steps at T = 44,044,288 from the same target,
    delta and residual equal bit for bit.  B14's counter set to 0 just
    before the named-axis steps and read just after.  Returns its
    launches."""
    import torch.distributed as dist
    from repro_torch.kernels.countsketch import countsketch_dense_cuda
    from repro_torch.launch import register_world_axis
    from repro_torch.optim.compression import (CompressionConfig,
                                               compressed_update)
    cfg = CompressionConfig()
    target = compression_target()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=pathlib.Path(tmp, "rendezvous").as_uri(),
            world_size=1, rank=0)
        try:
            register_world_axis("data")
            runs = {}
            for axis in (None, "data"):
                x = torch.zeros_like(target)
                residual = torch.zeros_like(target)
                torch.cuda.synchronize()
                countsketch_dense_cuda.launches = 0
                steps = []
                for _ in range(2):
                    delta, residual = compressed_update(
                        x - target, residual, axis, cfg, lr=0.3)
                    x = x - delta
                    steps.append((delta, residual))
                torch.cuda.synchronize()
                runs[axis] = steps, countsketch_dense_cuda.launches
        finally:
            dist.destroy_process_group()
    (named, launches), (single, _) = runs["data"], runs[None]
    for i, ((d1, r1), (d0, r0)) in enumerate(zip(named, single)):
        if not (bits_equal(d1, d0) and bits_equal(r1, r0)):
            raise AssertionError(f"compression over a 1-rank axis, step {i}: "
                                 "differs from axis_name=None")
    if launches != 2:
        raise AssertionError(f"compression over a 1-rank axis: {launches} "
                             "B14 launches")
    log(f"compression replica axis: compressed_update(axis_name='data') over "
        f"a 1-rank NCCL group equals axis_name=None bit for bit, 2 steps at "
        f"T={GRAD_T}; B14 launches {launches}")
    return launches


def visible_pairs(T: int, window: int) -> int:
    """(query, key) pairs a causal mask (and a window) leave, T = S."""
    return sum(min(t + 1, window or t + 1) for t in range(T))


def flash_attention_kernel_phase():
    """B15 at TinyLlama's attention shape, Mistral-NeMo's heads, Gemma-7B's
    and InternVL2-1B's reduced ones against its plain version (f32 within
    5e-5, bf16 within one bf16 rounding step), a launch per head == the
    batched launch and a repeat, bit for bit; timed (device time under the
    symbol of the kernel that the route takes, ``kernel_route``) against
    its bound (operations at the bf16 tensor-core rate, per visible (query,
    key) pair and dim: bf16 inputs 6; f32 inputs 24;
    bytes: q, k, v, o once) and against one
    ``scaled_dot_product_attention`` call (k/v expanded to every head
    before the call; the window case with a boolean mask).  Then the entry
    point ``flash_attention`` (model layout) runs the nine cases, its
    counters set to 0 just before and read just after: each kernel's count
    equals the cases routed to it, and each kernel runs; each output equals
    the batched launch bit for bit and lies within ORACLE_TOL of the port's
    ``chunked_attention``, B15's oracle.  Returns (reports, the entry
    point's launches by kernel name)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.attention import chunked_attention
    rng = np.random.default_rng(19)
    reports, layouts = [], []
    for label, H, K, D, dtype, window, (rtol, atol) in FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, FLASH_T, n, D), dtype=np.float32)).cuda().to(dtype)
                   for n in (H, K, K))
        qf, kf, vf = (a[0].transpose(0, 1).contiguous() for a in (q, k, v))
        kw = dict(group=H // K, causal=True, window=window)
        fn = functools.partial(kfa.flash_attention_cuda, qf, kf, vf, **kw)
        got = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = kfa.flash_attention_plain(qf, kf, vf, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (got.float() - want.float()).abs()
        if not bool((err <= atol + rtol * want.float().abs()).all()):
            raise AssertionError(f"B15 {label}: kernel differs from plain by "
                                 f"{err.max().item()} (rtol {rtol}, atol "
                                 f"{atol})")
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        if not torch.equal(fn().view(bits), got.view(bits)):
            raise AssertionError(f"B15 {label}: two runs differ")
        if label in FLASH_PER_HEAD:
            for h in range(H):
                one = kfa.flash_attention_cuda(
                    qf[h:h + 1], kf[h // kw["group"]][None],
                    vf[h // kw["group"]][None], **dict(kw, group=1))
                if not torch.equal(one[0].view(bits), got[h].view(bits)):
                    raise AssertionError(f"B15 {label}: head {h} alone "
                                         "differs from the batched launch")
        symbol = kfa.kernel_route(dtype, D)
        ops = 4 * H * visible_pairs(FLASH_T, window) * D
        bytes_moved = (2 * H + 2 * K) * FLASH_T * D * got.element_size()
        tc_ms = FLASH_OPS[symbol] / 4 * ops / BF16_TC_OPS_PER_S * 1e3
        bound = max(bytes_moved / HBM_BYTES_PER_S * 1e3, tc_ms)
        bound_by = "operations" if bound == tc_ms else "bytes"
        ms = time_ms(fn, reps=5)
        ran = []
        dev_ms, dev_src = device_ms(fn, symbol, reps=5, names=ran)
        qs, ks, vs = (a.transpose(1, 2).repeat_interleave(
            H // n, dim=1).contiguous() for a, n in ((q, H), (k, K), (v, K)))
        if window:
            pos = torch.arange(FLASH_T, device="cuda")
            mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None]
                                                  - window)
            sdpa = functools.partial(F.scaled_dot_product_attention, qs, ks,
                                     vs, attn_mask=mask)
        else:
            sdpa = functools.partial(F.scaled_dot_product_attention, qs, ks,
                                     vs, is_causal=True)
        lib_ms = time_ms(sdpa, reps=5)
        lib_err = (sdpa()[0].float() - got.float()).abs().max().item()
        del qs, ks, vs
        rep = {"shape": f"{label} B=1 T=S={FLASH_T} H={H} K={K} D={D}",
               "kernel": symbol, "ran": ran, "max_abs_err": err.max().item(),
               "ms": ms,
               "device_ms": dev_ms, "device_ms_source": dev_src,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
               "library_ms": lib_ms, "library": "scaled_dot_product_attention"}
        tc4_ms = ops / BF16_TC_OPS_PER_S * 1e3
        if dtype == torch.bfloat16:
            rep["bound_ms_bf16_tensor_cores"] = tc4_ms
            rep["bound_ms_split_tensor_cores"] = tc_ms
            rep["loads"] = "tma" if kfa.tma_loads(dtype, D) else "by value"
        else:
            rep["bound_ms_f32_fma_floor"] = ops / FP32_OPS_PER_S * 1e3
        log(f"B15 {label}: max |kernel - plain| {rep['max_abs_err']:.3g} "
            f"(rtol {rtol:.3g}, atol {atol:.3g}), repeat and per-head bit for "
            f"bit; kernel "
            f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device, "
            f"{', '.join(ran) or symbol}"
            + (f", {rep['loads']} loads" if "loads" in rep else "")
            + f"), plain {plain_ms:.1f} ms (one run), bound "
            f"{bound:.4f} ms ({bound_by}), "
            f"SDPA {lib_ms:.4f} ms (max |SDPA - kernel| {lib_err:.3g})"
            + (f"; bf16 tensor-core bounds {1.5 * tc4_ms:.4f} ms (6 ops a "
               f"pair and dim), {tc4_ms:.4f} ms (4 ops)"
               if dtype == torch.bfloat16 else ""))
        reports.append(rep)
        layouts.append((q, k, v, window, got))
    torch.cuda.synchronize()
    counter = kfa.flash_attention_cuda
    counter.launches = counter.tc_launches = counter.f32tc_launches = 0
    outs = [kfa.flash_attention(q, k, v, causal=True, window=window)
            for q, k, v, window, _ in layouts]
    torch.cuda.synchronize()
    launches = {kfa.BF16_TC_KERNEL: counter.tc_launches,
                kfa.F32_TC_KERNEL: counter.f32tc_launches}
    routed = {name: sum(kfa.kernel_route(q.dtype, q.shape[-1]) == name
                        for q, *_ in layouts) for name in launches}
    if counter.launches != len(layouts) or launches != routed or \
            not all(launches.values()):
        raise AssertionError(f"flash_attention: {counter.launches} launches "
                             f"for {len(layouts)} calls, by kernel "
                             f"{launches}, routed {routed}")
    oracle_err = []
    for out, (q, k, v, window, got) in zip(outs, layouts):
        bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        if not torch.equal(out[0].transpose(0, 1).contiguous().view(bits),
                           got.view(bits)):
            raise AssertionError("flash_attention (model layout) differs "
                                 "from the [BH, T, D] launch")
        want = chunked_attention(q, k, v, causal=True, window=window).float()
        tol = ORACLE_TOL[got.dtype]
        err = (out.float() - want).abs()
        oracle_err.append(err.max().item())
        if not bool((err <= tol + tol * want.abs()).all()):
            raise AssertionError(f"flash_attention differs from "
                                 f"chunked_attention by {oracle_err[-1]} "
                                 f"(tolerance {tol})")
        del want, err
    log(f"flash_attention entry point: {len(outs)} calls, B15 launches "
        f"by kernel {launches}, each equal to its [BH, T, D] launch bit for "
        f"bit; max |flash_attention - chunked_attention| "
        + ", ".join(f"{e:.3g}" for e in oracle_err))
    return reports, launches


def lm_rel(got, want) -> float:
    """max |got - want| over max |want|, in f32 on the CPU."""
    a, b = want.float().cpu(), got.float().cpu()
    return ((a - b).abs().max() / a.abs().max()).item()


def lm_near_ties(label: str, got, want) -> int:
    """Greedy picks of ``got`` against ``want``'s (logits ``[..., V]``):
    each pick that differs must sit at a near tie of ``want`` (top-2
    margin within LM_TOL of its largest magnitude).  Returns the count of
    such ties; raises on a pick that differs elsewhere."""
    g, w = got.float().cpu(), want.float().cpu()
    top2 = w.topk(2, dim=-1).values
    differ = g.argmax(-1) != w.argmax(-1)
    margin = (top2[..., 0] - top2[..., 1])[differ]
    if bool((margin > LM_TOL * w.abs().max()).any()):
        raise AssertionError(f"lm serve {label}: a greedy pick differs from "
                             f"the CPU's at margin {margin.max().item()}")
    return int(differ.sum())


def lm_card_vs_cpu(cfg):
    """Gate (b): forward and LM_CPU_B x LM_CPU_T decode steps at
    LM_CPU_LAYERS of full width, on the card and on the CPU, same weights."""
    import dataclasses

    from repro_torch.convert import model_params_to
    from repro_torch.models import Model
    small = dataclasses.replace(cfg, num_layers=LM_CPU_LAYERS)
    card = Model(small)
    params = card.init(torch.Generator(device="cuda").manual_seed(1))
    cpu = Model(small, device="cpu")
    cpu_params = model_params_to(params, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (LM_CPU_B, LM_CPU_T)).astype(np.int32))
    want, _ = cpu.forward(cpu_params, {"tokens": toks})
    got, _ = card.forward(params, {"tokens": toks.cuda()})
    rels, ties = [lm_rel(got, want)], lm_near_ties("forward", got, want)
    state = card.init_decode_state(LM_CPU_B, 32)
    cpu_state = cpu.init_decode_state(LM_CPU_B, 32)
    for t in range(LM_CPU_T):
        want, cpu_state = cpu.decode_step(cpu_params, toks[:, t:t + 1],
                                          cpu_state)
        got, state = card.decode_step(params, toks[:, t:t + 1].cuda(), state)
        rels.append(lm_rel(got, want))
        ties += lm_near_ties(f"decode step {t}", got, want)
    rels += [lm_rel(state["kv"][n], cpu_state["kv"][n]) for n in "kv"]
    if max(rels) > LM_TOL:
        raise AssertionError(f"lm serve: the card is {max(rels)} from the "
                             f"CPU (tolerance {LM_TOL})")
    if not torch.equal(state["slot_pos"].cpu(), cpu_state["slot_pos"]):
        raise AssertionError("lm serve: slot tables differ")
    log(f"lm serve (b) card == CPU at {LM_CPU_LAYERS} layers of full width: "
        f"forward and {LM_CPU_T} decode steps of B = {LM_CPU_B}, max rel "
        f"{max(rels):.3g} (tolerance {LM_TOL}), caches included; greedy "
        f"picks equal, {ties} near ties")
    return max(rels)


def lm_serve_phase(identity: str):
    """The LM serving path at tinyllama-1.1b's full config: (a) decode ==
    parallel forward, (b) the card against the CPU, (c) the launcher's
    engine drains and repeats, (d) decode-step p50, forward ms, tokens/s
    and peak memory.  The path reaches no hand-written kernel (JAX's model
    attends through the plain ``chunked_attention``): every launch counter
    is set to 0 before it and must read 0 after."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lm serve needs TF32 off")
    counters = reset_counters()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(LM_ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(v.numel() for v in lm_leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, not "
                             f"{cfg.param_count()}")
    # (a)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, LM_T)).astype(np.int32)).cuda()
    par, _ = model.forward(params, {"tokens": toks})
    state = model.init_decode_state(1, 32)
    inc = []
    for t in range(LM_T):
        lg, state = model.decode_step(params, toks[:, t:t + 1], state)
        inc.append(lg[:, 0])
    rel = lm_rel(torch.stack(inc, dim=1), par)
    if not rel < LM_DECODE_REL or not torch.isfinite(par.float()).all():
        raise AssertionError(f"lm serve: decode is {rel} from forward")
    log(f"lm serve (a) {LM_ARCH} ({cfg.num_layers} layers, "
        f"{n_params:,} parameters): decode == forward over T = {LM_T}, rel "
        f"{rel:.4g} (gate {LM_DECODE_REL})")
    # (b)
    cpu_rel = lm_card_vs_cpu(cfg)
    # (c)
    runs = [serve(LM_ARCH, requests=LM_REQUESTS, slots=LM_SLOTS,
                  max_new_tokens=LM_NEW, full=True)
            for _ in range(2)]
    outs = [[r.output for r in reqs] for reqs, _ in runs]
    if not all(r.done and len(r.output) == LM_NEW for reqs, _ in runs
               for r in reqs) or outs[0] != outs[1]:
        raise AssertionError(f"lm serve: the engine runs differ or did not "
                             f"drain: {outs}")
    tokens = LM_REQUESTS * LM_NEW
    tok_s = [tokens / seconds for _, seconds in runs]
    log(f"lm serve (c) ServeEngine drained {LM_REQUESTS} requests on "
        f"{LM_SLOTS} slots at {cfg.num_layers} layers twice, same tokens: "
        f"{outs[0]}")
    # (d)
    state = model.init_decode_state(LM_SLOTS, LM_MAX_SEQ)
    step_toks = torch.ones((LM_SLOTS, 1), dtype=torch.int32, device="cuda")
    step_ms = []
    for i in range(LM_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, state = model.decode_step(params, step_toks, state)
        b.record()
        b.synchronize()
        if i >= 2:
            step_ms.append(a.elapsed_time(b))
    busy_ms, kernels = lm_step_device(model, params, step_toks, state)
    fwd_toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, LM_FORWARD_T)).astype(np.int32)).cuda()
    fwd_ms = time_ms(lambda: model.forward(params, {"tokens": fwd_toks}),
                     reps=5)
    launches = sum(fn.launches for fn in counters.values())
    if launches:
        raise AssertionError(f"lm serve launched {launches} hand-written "
                             "kernels; its path has none")
    # a step reads the f32 weights, writes their bf16 casts and reads those
    # in the products (the KV cache is 44 MB); of an untied embedding table
    # it gathers and casts only the slots' rows
    step_values = n_params - (0 if cfg.tie_embeddings else
                              (cfg.vocab_size - LM_SLOTS) * cfg.d_model)
    numbers = {"decode_step_p50_ms": statistics.median(step_ms),
               "decode_slots": LM_SLOTS, "max_seq": LM_MAX_SEQ,
               "forward_ms": fwd_ms, "forward_B": 1, "forward_T": LM_FORWARD_T,
               "engine_tokens_per_s": tok_s,
               "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
               "step_device_kernels": kernels,
               "step_device_busy_ms": busy_ms,
               "step_device_busy_share": busy_ms / statistics.median(
                   step_ms),
               "step_byte_floor_ms":
                   step_values * (4 + 2 + 2) / HBM_BYTES_PER_S * 1e3,
               "step_byte_floor_bf16_weights_ms":
                   step_values * 2 / HBM_BYTES_PER_S * 1e3,
               "decode_vs_forward_rel": rel, "card_vs_cpu_rel": cpu_rel,
               "kernel_launches": launches}
    log(f"lm serve (d) {LM_ARCH} on {identity}: " + json.dumps(numbers))
    return numbers


def lm_step_device(model, params, toks, state):
    """One decode step under ``torch.profiler``: the device kernels it ran
    and their summed device time in ms (0 kernels where the trace holds no
    device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, toks, state)
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) / 1e3, len(spans)


def lm_leaves(tree):
    for v in tree.values():
        yield from lm_leaves(v) if isinstance(v, dict) else (v,)


def lm_train_opt(total_steps: int = LM_TRAIN_STEPS):
    """The launcher's optimizer settings (``launch/train.py``)."""
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=total_steps)


def lm_train_batch(vocab: int, B: int, T: int, dev, step: int = 0):
    """The pipeline's batch of ``step`` (seed 0) as ``[M, B / M, T]``
    tensors on ``dev``."""
    from repro_torch.data.synthetic import token_stream
    toks = token_stream(0, step, B, T, vocab).astype(np.int32)
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.reshape(LM_TRAIN_M, B // LM_TRAIN_M, T))).to(dev)
        for k, v in (("tokens", toks[:, :-1]), ("labels", toks[:, 1:]))}


def lm_train_card_vs_cpu(cfg):
    """Gate (a): one micro-batch's gradients and one train step at
    LM_CPU_LAYERS of full width, on the card and on the CPU, same weights
    and batch."""
    import dataclasses

    from repro_torch import tree as tr
    from repro_torch.convert import model_params_to
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.train import loss_and_grads, make_train_step
    small = dataclasses.replace(cfg, num_layers=LM_CPU_LAYERS)
    card = Model(small)
    params = card.init(torch.Generator(device="cuda").manual_seed(1))
    runs = {}
    for dev, model, prm in (("cuda", card, params),
                            ("cpu", Model(small, device="cpu"),
                             model_params_to(params, "cpu"))):
        batch = lm_train_batch(cfg.vocab_size, LM_TRAIN_M, LM_TRAIN_CPU_T,
                               dev)
        _, grads = loss_and_grads(model, prm, {k: v[0] for k, v in
                                               batch.items()},
                                  q_chunk=LM_TRAIN_CPU_T,
                                  k_chunk=LM_TRAIN_CPU_T)
        step = make_train_step(model, lm_train_opt(), q_chunk=LM_TRAIN_CPU_T,
                               k_chunk=LM_TRAIN_CPU_T)
        opt0 = adamw.init_opt_state(prm, lm_train_opt())
        new, opt, metrics = step(prm, opt0, batch)
        runs[dev] = (prm, grads, new, opt, metrics)
    (p0, g_card, new_card, opt_card, m_card), \
        (_, g_cpu, new_cpu, opt_cpu, m_cpu) = runs["cuda"], runs["cpu"]
    rels = {"loss": abs(m_card["loss"].item() - m_cpu["loss"].item())
            / abs(m_cpu["loss"].item()),
            "grad_norm": abs(m_card["grad_norm"].item()
                             - m_cpu["grad_norm"].item())
            / m_cpu["grad_norm"].item()}
    rels["grads"] = max(lm_rel(a, b) for a, b in zip(tr.leaves(g_card),
                                                      tr.leaves(g_cpu)))
    rels["moments"] = max(lm_rel(a, b) for k in ("mu", "nu") for a, b in
                          zip(tr.leaves(opt_card[k]), tr.leaves(opt_cpu[k])))
    ill = 0.0
    for got, want, old, mu in zip(tr.leaves(new_card), tr.leaves(new_cpu),
                                  tr.leaves(p0), tr.leaves(opt_cpu["mu"])):
        old = old.cpu()
        want_up, got_up = want - old, got.cpu() - old
        off = (got_up - want_up).abs() > LM_GRAD_TOL * want_up.abs().max()
        mu = mu.float().abs()
        if bool((off & (mu >= LM_WELL_POSED * mu.max())).any()):
            raise AssertionError("lm train (a): an update on a well-posed "
                                 "entry differs from the CPU's")
        ill = max(ill, off.float().mean().item())
    if (rels["loss"] > LM_TOL or rels["grad_norm"] > 1e-3
            or rels["grads"] > LM_GRAD_TOL or rels["moments"] > LM_GRAD_TOL
            or ill > LM_ILL_SHARE or int(m_card["step"]) != 1):
        raise AssertionError(f"lm train (a): the card is off the CPU: "
                             f"{rels}, ill-posed share {ill}")
    log(f"lm train (a) card == CPU at {LM_CPU_LAYERS} layers of full width, "
        f"M = {LM_TRAIN_M} x 1 x {LM_TRAIN_CPU_T}: rel loss "
        f"{rels['loss']:.3g} (tol {LM_TOL}), grad_norm "
        f"{rels['grad_norm']:.3g} (1e-3), every gradient leaf "
        f"{rels['grads']:.3g} and moment {rels['moments']:.3g} (tol "
        f"{LM_GRAD_TOL}); updates equal on the well-posed entries, "
        f"{ill:.4f} of a leaf's entries off at most (gate {LM_ILL_SHARE})")
    return rels


def lm_trainer(cfg, steps: int, total_steps: int, ckpt_dir=None):
    """The port's Trainer at the phase's batch; returns (trainer,
    history)."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tcfg = TrainerConfig(steps=steps, global_batch=LM_TRAIN_B,
                         seq=LM_TRAIN_SEQ, microbatches=LM_TRAIN_M,
                         ckpt_dir=ckpt_dir, log_every=1,
                         opt=lm_train_opt(total_steps))
    trainer = Trainer(cfg, tcfg, log_fn=lambda s: log(f"  {s}"))
    return trainer, trainer.run()


def lm_train_resume(cfg):
    """Gate (b): LM_TRAIN_STEPS straight, then LM_TRAIN_RESUME steps with
    a checkpoint and a fresh Trainer that restores it and runs the rest:
    the rest's losses and grad norms and the final state equal bit for
    bit.  The checkpoints (f32 params, bf16 moments stored as f32) go to a
    temporary directory under the checkout's ``build/``."""
    from repro_torch import tree as tr
    straight, hist = lm_trainer(cfg, LM_TRAIN_STEPS, LM_TRAIN_STEPS)
    if not (np.isfinite(hist["loss"]).all()
            and np.isfinite(hist["grad_norm"]).all()):
        raise AssertionError(f"lm train (b): non-finite history {hist}")
    build = SRC.parent / "build"
    build.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(build).free / 1e9
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.perf_counter()
        lm_trainer(cfg, LM_TRAIN_RESUME, LM_TRAIN_STEPS, ckpt_dir=tmp)
        first_s = time.perf_counter() - t0
        ckpt_gb = sum(f.stat().st_size for f in pathlib.Path(tmp).rglob(
            "*.npy")) / 1e9
        t0 = time.perf_counter()
        resumed, hist_b = lm_trainer(cfg, LM_TRAIN_STEPS, LM_TRAIN_STEPS,
                                     ckpt_dir=tmp)
        resumed_s = time.perf_counter() - t0
    if hist_b["step"][0] != LM_TRAIN_RESUME:
        raise AssertionError(f"lm train (b): resumed at {hist_b['step']}")
    same = (hist_b["loss"] == hist["loss"][LM_TRAIN_RESUME:]
            and hist_b["grad_norm"] == hist["grad_norm"][LM_TRAIN_RESUME:]
            and all(bits_equal(a, b) if a.dtype != torch.bfloat16
                    else torch.equal(a, b) for a, b in zip(
                        tr.leaves(straight.state), tr.leaves(resumed.state))))
    if not same:
        raise AssertionError(f"lm train (b): resume differs from the "
                             f"straight run: {hist} vs {hist_b}")
    del resumed
    log(f"lm train (b) {LM_ARCH} Trainer, {cfg.num_layers} layers, "
        f"{LM_TRAIN_B} x {LM_TRAIN_SEQ} tokens a step in {LM_TRAIN_M} "
        f"micro-batches: losses {hist['loss']}, grad norms "
        f"{hist['grad_norm']}; resumed from step {LM_TRAIN_RESUME} (a "
        f"{ckpt_gb:.2f} GB checkpoint, {free_gb:.0f} GB free before it; the "
        f"first run with its save {first_s:.1f} s, the resumed run with its "
        f"restore and save {resumed_s:.1f} s): losses, grad norms and the "
        f"final params and moments equal to the straight run bit for bit")
    return straight, hist


def lm_train_profile(trainer, cfg):
    """One train step of the 22-layer model under ``torch.profiler`` (after
    a warm one): the device's summed kernel time over the step's wall time,
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import make_train_step
    step = make_train_step(trainer.model, lm_train_opt(),
                           q_chunk=LM_TRAIN_SEQ, k_chunk=LM_TRAIN_SEQ)
    params, opt = trainer.state
    batch = lm_train_batch(cfg.vocab_size, LM_TRAIN_B, LM_TRAIN_SEQ, "cuda")
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "kernels": sum(n for _, n in by_name.values()),
            "top_kernels": [{"name": name[:90], "ms": ms, "launches": n}
                            for name, (ms, n) in top]}


def flat_grads(trainer, cfg):
    """Each micro-batch's gradient of the pipeline's first batch at the
    trainer's final params, flattened in the tree's order: ``[M, T]``
    f32."""
    from repro_torch import tree as tr
    from repro_torch.train import loss_and_grads
    params = trainer.state[0]
    batch = lm_train_batch(cfg.vocab_size, LM_TRAIN_B, LM_TRAIN_SEQ, "cuda")
    T = sum(p.numel() for p in tr.leaves(params))
    flat = torch.empty((LM_TRAIN_M, T), dtype=torch.float32, device="cuda")
    for i in range(LM_TRAIN_M):
        _, grads = loss_and_grads(trainer.model, params,
                                  {k: v[i] for k, v in batch.items()},
                                  q_chunk=LM_TRAIN_SEQ, k_chunk=LM_TRAIN_SEQ)
        lo = 0
        for g in tr.leaves(grads):
            flat[i, lo:lo + g.numel()] = g.reshape(-1)
            lo += g.numel()
        del grads
    return flat


def telemetry_rows(flat):
    """(w, keys, zn) of ``sketch_gradient``'s ICWS launch over ``flat``
    ``[R, T]``."""
    norm = torch.linalg.vector_norm(flat, dim=-1)
    zn = flat / torch.clamp(norm, min=1e-30)[:, None]
    keys = torch.arange(flat.shape[1], dtype=torch.int32,
                        device=flat.device).expand_as(flat).contiguous()
    return zn * zn, keys, zn


def lm_train_telemetry(flat):
    """Gate (c): the telemetry's main path -- ``sketch_gradient`` of the
    ``[2, T]`` micro-batch gradients (one B1 launch), ``estimate_pairwise``
    (one B3 launch), and ``gradient_agreement`` of the first over a 1-rank
    NCCL replica axis (one each again) -- with every counter set to 0
    just before and read just after; the estimated cosines beside the
    exact ones; then B1 at full T timed, B1 on the first TEL_PLAIN_N
    entries and B3 on the main path's sketches against their plain
    versions.  Returns (launches, B1 report, B3 report)."""
    import torch.distributed as dist

    from repro_torch.kernels import estimate as ke
    from repro_torch.kernels import icws_sketch as ks
    from repro_torch.launch import register_world_axis
    from repro_torch.train import telemetry as tel
    cfg = tel.TelemetryConfig(m=TEL_M)
    R, T = flat.shape
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    counters = reset_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sk = tel.sketch_gradient(flat, cfg)
        est = tel.estimate_pairwise(sk, cfg)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
    b1_spans = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and "icws_sketch_kernel" in e.name]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=pathlib.Path(tmp, "rendezvous").as_uri(),
            world_size=1, rank=0)
        try:
            register_world_axis("data")
            agree = tel.gradient_agreement(flat[0], "data", cfg)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: 0 for name in counters}
    want.update(icws_sketch=2, estimate_pairs=2)
    if launches != want:
        raise AssertionError(f"lm train (c): launches {launches}")
    cos = (est / torch.outer(sk["norm"], sk["norm"])).cpu()
    exact = torch.zeros((R, R), dtype=torch.float64, device=flat.device)
    for lo in range(0, T, 1 << 26):
        part = flat[:, lo:lo + (1 << 26)].double()
        exact += part @ part.T
    norms = exact.diagonal().sqrt()
    exact_cos = (exact / torch.outer(norms, norms)).float().cpu()
    err = (cos - exact_cos).abs().max().item()
    if not (torch.isfinite(cos).all() and err <= TEL_COS_GATE
            and abs(agree.item() - cos[0, 0].item()) <= 1e-5):
        raise AssertionError(f"lm train (c): cosines {cos.tolist()} against "
                             f"exact {exact_cos.tolist()}, agreement "
                             f"{agree.item()}")
    # B1 at the full T: the main path's launch, from its trace (a trace with
    # no device activity, seen late in long runs: the launch again, timed
    # with CUDA events, and it must repeat the main path's bits)
    live = int((flat != 0).sum().item())
    if b1_spans:
        b1_ms = sum(b1_spans) / 1e3
        b1_source = "profiler, the main path's launch"
    else:
        w, keys, zn = telemetry_rows(flat)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        again = ks.icws_sketch_cuda(w, keys, zn, m=TEL_M, seed=cfg.seed)
        b.record()
        b.synchronize()
        b1_ms, b1_source = a.elapsed_time(b), "events, one launch"
        if not (torch.equal(again[0], sk["fp"])
                and torch.equal(again[1], sk["val"])):
            raise AssertionError("lm train (c): B1 at full T does not "
                                 "repeat")
        del w, keys, zn, again
    b1_bound, b1_by = bound_of(R * T * 12 + R * TEL_M * 16,
                               ICWS_OPS_PER_DRAW * live * TEL_M)
    # B1 against its plain version on the rows' first TEL_PLAIN_N entries
    args = telemetry_rows(flat[:, :TEL_PLAIN_N].contiguous())
    got = ks.icws_sketch_cuda(*args, m=TEL_M, seed=cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ks.icws_sketch_plain(*args, m=TEL_M, seed=cfg.seed)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    agree_fp = got[0] == plain[0]
    share = agree_fp.float().mean().item()
    b1_err = (got[1] - plain[1])[agree_fp].abs().max().item()
    if share < 0.99 or b1_err != 0.0:
        raise AssertionError(f"lm train (c): B1 on {TEL_PLAIN_N} entries "
                             f"agrees with plain on {share} (val err "
                             f"{b1_err})")
    prefix_ms = time_ms(lambda: ks.icws_sketch_cuda(*args, m=TEL_M,
                                                    seed=cfg.seed), reps=3)
    prefix_live = int((args[0] > 0).sum().item())
    prefix_bound, _ = bound_of(R * TEL_PLAIN_N * 12 + R * TEL_M * 16,
                               ICWS_OPS_PER_DRAW * prefix_live * TEL_M)
    del args, got, plain
    # B3 on the main path's sketches, pairwise at P = R^2
    fp, val = sk["fp"], sk["val"]
    pair_args = (fp.repeat_interleave(R, 0), val.repeat_interleave(R, 0),
                 fp.repeat(R, 1), val.repeat(R, 1))
    b3, _ = pair_case(f"B3 P={R * R} m={TEL_M}", ke.estimate_partials_cuda,
                      ke.estimate_partials_plain, pair_args,
                      tests=R * R * TEL_M,
                      bytes_moved=4 * R * R * TEL_M * 4 + 2 * R * R * 4,
                      symbol="estimate_pairs_kernel")
    b1 = {"shape": f"B={R} N={T} m={TEL_M}", "max_abs_err": b1_err,
          "ms": b1_ms, "ms_source": b1_source,
          "bound_ms": b1_bound, "bound_by": b1_by, "live": live,
          "group_size": ks._group_size(R, TEL_M, T),
          "plain_ms": plain_ms, "plain_shape":
              f"B={R} N={TEL_PLAIN_N} m={TEL_M}",
          "kernel_ms_at_plain_shape": prefix_ms,
          "bound_ms_at_plain_shape": prefix_bound, "fp_agree": share,
          "fp_slots_differing": int((~agree_fp).sum().item())}
    log(f"lm train (c) telemetry over {R} micro-batch gradients of T = {T}: "
        f"estimated cosines {cos.tolist()}, exact {exact_cos.tolist()} (max "
        f"|err| {err:.4f}, gate {TEL_COS_GATE}); gradient_agreement over a "
        f"1-rank NCCL axis {agree.item():.6f}; main path {path_s:.2f} s; B1 "
        f"at B = {R}, N = {T}, m = {TEL_M}: {b1_ms:.1f} ms ({b1_source}; "
        f"bound {b1_bound:.1f} ms, {b1_by}, {live} live entries, "
        f"{b1['group_size']} threads a (row, t)); on the first "
        f"{TEL_PLAIN_N} entries fingerprints agree with plain on "
        f"{share:.6f} ({b1['fp_slots_differing']} slots differ), values "
        f"equal where they agree, kernel {prefix_ms:.2f} ms, plain "
        f"{plain_ms:.1f} ms; B3 at P = {R * R}: {b3['ms']:.4f} ms, bound "
        f"{b3['bound_ms']:.6f} ms; launches {want}")
    return launches, b1, b3


def lm_train_phase(identity: str):
    """The LM training path at tinyllama-1.1b's full config: (a) the card
    against the CPU at two layers, (b) the Trainer at 22 layers, straight
    and resumed from a checkpoint, bit for bit, (d) its step p50,
    tokens/s, peak memory and a profiled step, (c) the sketch gradient
    telemetry through B1 and B3.  Training itself launches no
    hand-written kernel: every counter is set to 0 before (a) and must
    read 0 after (d); the telemetry's launches are counted apart.  Returns
    (the telemetry's launches by kernel, B1's and B3's reports)."""
    from repro_torch import configs
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lm train needs TF32 off")
    cfg = configs.get(LM_ARCH)
    counters = reset_counters()
    rels = lm_train_card_vs_cpu(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, hist = lm_train_resume(cfg)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = lm_train_profile(trainer, cfg)
    trained = sum(fn.launches for fn in counters.values())
    if trained:
        raise AssertionError(f"lm train launched {trained} hand-written "
                             "kernels outside the telemetry; its training "
                             "path has none")
    step_ms = statistics.median(hist["step_time"][1:]) * 1e3
    numbers = {"train_step_p50_ms": step_ms,
               "tokens_per_s": LM_TRAIN_B * LM_TRAIN_SEQ / step_ms * 1e3,
               "step_times_ms": [t * 1e3 for t in hist["step_time"]],
               "global_batch": LM_TRAIN_B, "seq": LM_TRAIN_SEQ,
               "microbatches": LM_TRAIN_M, "layers": cfg.num_layers,
               "peak_memory_GiB": peak, "card_vs_cpu_rel": rels, **prof}
    log(f"lm train (d) {LM_ARCH} on {identity}: " + json.dumps(numbers))
    flat = flat_grads(trainer, cfg)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    out = lm_train_telemetry(flat)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"lm train peak memory {peak:.2f} GiB (training and telemetry) on "
        f"{identity}")
    return out


def moe_route_check(label: str, got_routes, want_routes, k: int, B: int,
                    T: int, margin: float = MOE_ROUTE_MARGIN,
                    capacity: int = 0):
    """The routing rule over a stack of MoE layers: ``got_routes`` against
    the reference's ``want_routes`` (each layer's ``(top_e [B * T, k],
    probs [B * T, E])``, rows in sequence order, each row's experts in
    falling probability).  A row whose top-k set differs must sit at a
    near tie of the reference (its k-th and (k+1)-th probabilities within
    ``margin`` of the k-th), and a row whose first expert differs (the
    load-balance loss counts first choices) at a near tie of its first and
    second, unless its input already differs: a row at or before it in
    its sequence was routed apart in an earlier layer (attention carries
    that row's change forward).  Given the runs' ``capacity``, a row whose
    kept experts differ because another row's routing moved its rank in an
    expert past the capacity counts as routed apart, without a tie of its
    own.  Returns (the clean rows, a boolean [B * T]: no row at or before
    them routed apart in any layer; the rows routed apart in some layer;
    the rows whose first choice alone differs)."""
    from repro_torch.models import moe
    apart = torch.zeros((B, T), dtype=torch.bool)
    first_apart = 0
    for layer, ((ge, _), (we, wp)) in enumerate(zip(got_routes,
                                                    want_routes)):
        ge, we, wp = ge.cpu(), we.cpu(), wp.float().cpu()
        differ = (ge.sort(-1).values != we.sort(-1).values).any(-1)
        differ = differ.view(B, T)
        first = (ge[:, 0] != we[:, 0]).view(B, T)
        moved = apart.int().cummax(dim=1).values.bool()
        top = wp.topk(k + 1, dim=-1).values
        gap = ((top[:, k - 1] - top[:, k]) / top[:, k - 1]).view(B, T)
        gap1 = ((top[:, 0] - top[:, 1]) / top[:, 0]).view(B, T)
        bad = ~moved & ((differ & (gap > margin))
                        | (first & (gap1 > margin)))
        if bool(bad.any()):
            raise AssertionError(
                f"lm moe {label}: layer {layer} routes {int(bad.sum())} rows "
                f"apart from the reference away from a near tie (gaps "
                f"{gap[bad].tolist()}, first gaps {gap1[bad].tolist()}, "
                f"margin {margin})")
        first_apart += int((first & ~differ).sum())
        if capacity:
            kept = []
            for e in (ge, we):
                pos = moe._positions_in_expert(e.reshape(-1), wp.shape[-1])
                m = torch.zeros_like(wp, dtype=torch.bool)
                m.scatter_(1, e, (pos < capacity).view(e.shape))
                kept.append(m)
            differ = differ | (kept[0] != kept[1]).any(-1).view(B, T)
        apart = apart | differ
    clean = ~apart.int().cummax(dim=1).values.bool()
    return clean.reshape(-1), int(apart.sum()), first_apart


def moe_aux(routes, probs_routes) -> float:
    """The load-balance loss summed over the layers, of the first choices
    in ``routes`` and the probabilities in ``probs_routes`` (JAX's
    formula, in f64): the reference's aux as the other run's first
    choices would make it."""
    total = 0.0
    for (top_e, _), (_, probs) in zip(routes, probs_routes):
        probs = probs.double().cpu()
        N, E = probs.shape
        density = torch.bincount(top_e[:, 0].cpu(), minlength=E).double() / N
        total += E * float((density * probs.mean(dim=0)).sum())
    return total


def decode_routes(routes, layers: int, T: int):
    """``record_routes``' list from T decode steps of B rows (a step's
    layers in order) as each layer's ``(top_e, probs)`` over the ``[B *
    T]`` rows in sequence order, as a forward's."""
    out = []
    for layer in range(layers):
        steps = [routes[t * layers + layer] for t in range(T)]
        out.append(tuple(torch.stack([s[i] for s in steps], dim=1).flatten(
            0, 1) for i in range(2)))
    return out


def lm_moe_card_vs_cpu(cfg):
    """Gate (b): the logits of LM_CPU_B x LM_CPU_T tokens under the routing
    rule, and one loss-and-gradient step on MOE_GRAD_B x MOE_GRAD_T tokens
    with the card replaying the CPU's routing (its own routing of them
    held to the rule), at LM_CPU_LAYERS of full width, on the card and on
    the CPU, same weights."""
    import dataclasses

    from repro_torch import tree as tr
    from repro_torch.convert import model_params_to
    from repro_torch.models import Model, moe
    from repro_torch.train import loss_and_grads
    small = dataclasses.replace(cfg, num_layers=LM_CPU_LAYERS)
    k = cfg.num_experts_per_tok
    card = Model(small)
    params = card.init(torch.Generator(device="cuda").manual_seed(1))
    cpu = Model(small, device="cpu")
    cpu_params = model_params_to(params, "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_CPU_B, LM_CPU_T)).astype(np.int32))
    runs = {}
    for dev, model, prm in (("cuda", card, params), ("cpu", cpu, cpu_params)):
        with moe.record_routes() as routes:
            logits, aux = model.forward(prm, {"tokens": toks.to(dev)})
        runs[dev] = (logits, aux, list(routes))
    (got, got_aux, got_routes), (want, want_aux, want_routes) = \
        runs["cuda"], runs["cpu"]
    alike, apart, first = moe_route_check(
        "forward", got_routes, want_routes, k, LM_CPU_B, LM_CPU_T,
        capacity=moe.capacity(LM_CPU_B * LM_CPU_T, cfg))
    V = cfg.vocab_size
    got_rows, want_rows = got.reshape(-1, V)[alike.cuda()], \
        want.reshape(-1, V)[alike]
    # the CPU's aux as the card's first choices make it: a first choice
    # swapped at a near tie moves the loss by E / N of a probability
    want_aux = moe_aux(got_routes, want_routes)
    rels = {"logits": lm_rel(got_rows, want_rows),
            "aux": abs(got_aux.item() - want_aux) / want_aux}
    ties = lm_near_ties("moe forward", got_rows, want_rows)
    # one loss-and-gradient step, the card replaying the CPU's routing (a
    # token routed apart changes every gradient leaf's sum, not only its
    # experts'); the card's own routing of the batch under the rule
    gtoks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        MOE_GRAD_B, MOE_GRAD_T + 1)).astype(np.int32))
    batches = {dev: {"tokens": gtoks[:, :-1].to(dev),
                     "labels": gtoks[:, 1:].to(dev)} for dev in ("cpu",
                                                                 "cuda")}
    chunks = dict(q_chunk=MOE_GRAD_T, k_chunk=MOE_GRAD_T)
    grads = {}
    with moe.record_routes() as r_cpu:
        grads["cpu"] = loss_and_grads(cpu, cpu_params, batches["cpu"],
                                      **chunks)
        with torch.no_grad():
            grads["cpu"] += (cpu.loss(cpu_params, batches["cpu"],
                                      **chunks)[1]["aux"],)
    with moe.record_routes() as own:
        card.forward(params, batches["cuda"], **chunks)
    _, g_apart, g_first = moe_route_check(
        "gradient batch", own, r_cpu[:LM_CPU_LAYERS], k, MOE_GRAD_B,
        MOE_GRAD_T, capacity=moe.capacity(MOE_GRAD_B * MOE_GRAD_T, cfg))
    with moe.replay_routes(r_cpu):
        grads["cuda"] = loss_and_grads(card, params, batches["cuda"],
                                       **chunks)
        with torch.no_grad():
            grads["cuda"] += (card.loss(params, batches["cuda"],
                                        **chunks)[1]["aux"],)
    (g_loss, g_card, g_aux), (w_loss, g_cpu, w_aux) = \
        grads["cuda"], grads["cpu"]
    rels["loss"] = abs(g_loss.item() - w_loss.item()) / abs(w_loss.item())
    rels["grad_aux"] = abs(g_aux.item() - w_aux.item()) / w_aux.item()
    leaves = {}
    for (path, a), b in zip(tr.leaves_with_paths(g_card), tr.leaves(g_cpu)):
        # lm train (a)'s tiers: within LM_GRAD_TOL of the leaf's largest CPU
        # magnitude on the well-posed entries (at least LM_WELL_POSED of
        # it), at most LM_ILL_SHARE of the others off by more
        a, b = a.float().cpu(), b.float()
        big = b.abs().max()
        off = (a - b).abs() / big
        well = b.abs() >= LM_WELL_POSED * big
        leaves["/".join(map(str, path))] = (
            off.max().item(), off[well].max().item(),
            ((off > LM_GRAD_TOL) & ~well).float().mean().item())
    rels["grads_all"] = max(v[0] for v in leaves.values())
    rels["grads"] = max(v[1] for v in leaves.values())
    rels["ill_share"] = max(v[2] for v in leaves.values())
    rels["worst_leaf"] = max(leaves, key=lambda n: leaves[n][1])
    if (rels["logits"] > LM_TOL or rels["loss"] > LM_TOL
            or rels["grads"] > LM_GRAD_TOL or rels["aux"] > LM_TOL
            or rels["grad_aux"] > LM_TOL or rels["ill_share"] > LM_ILL_SHARE):
        raise AssertionError(
            f"lm moe (b): the card is off the CPU: {rels}; rows routed "
            f"apart {apart} / {g_apart}, first choices swapped {first} / "
            f"{g_first}; by leaf (all, well-posed, ill-posed share off): "
            f"{leaves}")
    n_apart = (apart, g_apart, first, g_first)
    log(f"lm moe (b) card == CPU at {LM_CPU_LAYERS} layers of full width: "
        f"logits of {LM_CPU_B} x {LM_CPU_T} tokens rel {rels['logits']:.3g} "
        f"on the {int(alike.sum())} rows with no row at or before them "
        f"routed apart (tolerance {LM_TOL}; {n_apart[0]} rows routed apart, "
        f"each at a near tie within {MOE_ROUTE_MARGIN} of the CPU's k-th "
        f"probability or after such a row; greedy picks "
        f"equal, {ties} near ties), aux rel {rels['aux']:.3g} "
        f"({LM_TOL}; {first} first choices swapped at a near tie); "
        f"one loss-and-gradient step on {MOE_GRAD_B} x {MOE_GRAD_T} tokens "
        f"(its own routing of them: {g_apart} rows routed apart, {g_first} "
        f"first choices swapped, each at a near tie or after one; the "
        f"card replaying the CPU's routing): loss rel {rels['loss']:.3g} "
        f"({LM_TOL}), aux rel {rels['grad_aux']:.3g}, every gradient leaf "
        f"{rels['grads']:.3g} at most on its well-posed entries "
        f"({rels['worst_leaf']}; {LM_GRAD_TOL}; {rels['grads_all']:.3g} on "
        f"all, {rels['ill_share']:.4f} of a leaf's ill-posed entries off at "
        f"most, gate {LM_ILL_SHARE})")
    return rels, n_apart


def lm_moe_phase(identity: str):
    """The moe family at qwen3-moe-30b-a3b's published widths, MOE_LAYERS
    deep: (c) the launcher refuses all 48 layers before it allocates, and
    its engine drains twice with the same tokens; (a) decode == forward;
    (d) decode-step p50, forward ms, tokens/s, peak memory and a profiled
    step; (b) the card against the CPU at two layers under the routing
    rule; (e) a two-layer Trainer twice, bit for bit.  The path reaches no
    hand-written kernel: every counter is set to 0 before it and must read
    0 after."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import tree as tr
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, moe
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lm moe needs TF32 off")
    counters = reset_counters()
    torch.cuda.reset_peak_memory_stats()
    full = configs.get(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    # (c)
    before = torch.cuda.memory_allocated()
    try:
        serve(MOE_ARCH, full=True)
        raise AssertionError("lm moe: all 48 layers were served")
    except MemoryError as e:
        if (f"{4 * full.param_count():,} bytes" not in str(e)
                or torch.cuda.memory_allocated() != before):
            raise
        refusal = str(e)
    runs = [serve(MOE_ARCH, requests=LM_REQUESTS, slots=LM_SLOTS,
                  max_new_tokens=LM_NEW, full=True, layers=MOE_LAYERS)
            for _ in range(2)]
    outs = [[r.output for r in reqs] for reqs, _ in runs]
    if not all(r.done and len(r.output) == LM_NEW for reqs, _ in runs
               for r in reqs) or outs[0] != outs[1]:
        raise AssertionError(f"lm moe: the engine runs differ or did not "
                             f"drain: {outs}")
    tok_s = [LM_REQUESTS * LM_NEW / seconds for _, seconds in runs]
    log(f"lm moe (c) {refusal}; ServeEngine drained {LM_REQUESTS} requests "
        f"on {LM_SLOTS} slots at {MOE_LAYERS} layers twice, same tokens: "
        f"{outs[0]}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    # (a)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(v.numel() for v in tr.leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, not "
                             f"{cfg.param_count()}")
    ample = Model(dataclasses.replace(cfg, capacity_factor=MOE_DECODE_CF))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (MOE_DECODE_B, LM_T)).astype(np.int32)).cuda()
    with moe.record_routes() as par_routes:
        par, _ = ample.forward(params, {"tokens": toks})
    state = ample.init_decode_state(MOE_DECODE_B, 32)
    inc = []
    with moe.record_routes() as inc_routes:
        for t in range(LM_T):
            lg, state = ample.decode_step(params, toks[:, t:t + 1], state)
            inc.append(lg[:, 0])
    clean, apart, _ = moe_route_check(
        "decode", decode_routes(inc_routes, MOE_LAYERS, LM_T), par_routes,
        cfg.num_experts_per_tok, MOE_DECODE_B, LM_T, margin=LM_DECODE_REL)
    V = cfg.vocab_size
    inc = torch.stack(inc, dim=1).reshape(-1, V)
    rel = lm_rel(inc[clean.cuda()], par.reshape(-1, V)[clean.cuda()])
    if (not rel < LM_DECODE_REL or not torch.isfinite(par.float()).all()
            or not bool(clean.any())):
        raise AssertionError(f"lm moe: decode is {rel} from forward on "
                             f"{int(clean.sum())} rows")
    log(f"lm moe (a) {MOE_ARCH} ({MOE_LAYERS} of {full.num_layers} layers, "
        f"{n_params:,} parameters): decode == forward over B = "
        f"{MOE_DECODE_B}, T = {LM_T} at capacity_factor {MOE_DECODE_CF}, "
        f"rel {rel:.4g} (gate {LM_DECODE_REL}) on the {int(clean.sum())} "
        f"of {MOE_DECODE_B * LM_T} rows with no row at or before them routed "
        f"apart; {apart} rows routed apart, each at a near tie within "
        f"{LM_DECODE_REL} of the forward's k-th probability or after such a "
        f"row")
    del par, inc, state
    # (d)
    state = model.init_decode_state(LM_SLOTS, LM_MAX_SEQ)
    step_toks = torch.ones((LM_SLOTS, 1), dtype=torch.int32, device="cuda")
    step_ms = []
    for i in range(LM_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, state = model.decode_step(params, step_toks, state)
        b.record()
        b.synchronize()
        if i >= 2:
            step_ms.append(a.elapsed_time(b))
    busy_ms, kernels = lm_step_device(model, params, step_toks, state)
    fwd_toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, LM_FORWARD_T)).astype(np.int32)).cuda()
    fwd_ms = time_ms(lambda: model.forward(params, {"tokens": fwd_toks}),
                     reps=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, params, ample, state
    gc.collect()
    torch.cuda.empty_cache()
    # a step reads every f32 weight, writes its bf16 cast and reads that in
    # the products (JAX's einsum over all E experts); of the untied
    # embedding table it gathers and casts only the slots' rows
    step_values = n_params - (cfg.vocab_size - LM_SLOTS) * cfg.d_model
    expert_values = MOE_LAYERS * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff
    # (b)
    rels, n_apart = lm_moe_card_vs_cpu(full)
    gc.collect()
    torch.cuda.empty_cache()
    # (e)
    small = dataclasses.replace(full, num_layers=LM_CPU_LAYERS)
    first, hist = lm_trainer(small, LM_TRAIN_STEPS, LM_TRAIN_STEPS)
    second, hist_b = lm_trainer(small, LM_TRAIN_STEPS, LM_TRAIN_STEPS)
    same = (hist_b["loss"] == hist["loss"]
            and hist_b["grad_norm"] == hist["grad_norm"]
            and all(bits_equal(a, b) if a.dtype != torch.bfloat16
                    else torch.equal(a, b) for a, b in zip(
                        tr.leaves(first.state), tr.leaves(second.state))))
    if not (same and np.isfinite(hist["loss"]).all()):
        raise AssertionError(f"lm moe (e): two Trainer runs differ: {hist} "
                             f"vs {hist_b}")
    train_ms = statistics.median(hist["step_time"][1:]) * 1e3
    log(f"lm moe (e) {LM_CPU_LAYERS}-layer Trainer, {LM_TRAIN_B} x "
        f"{LM_TRAIN_SEQ} tokens a step in {LM_TRAIN_M} micro-batches: "
        f"losses {hist['loss']}, grad norms {hist['grad_norm']}; a second "
        f"run equal bit for bit (losses, grad norms, params, moments)")
    del first, second
    gc.collect()
    torch.cuda.empty_cache()
    launches = sum(fn.launches for fn in counters.values())
    if launches:
        raise AssertionError(f"lm moe launched {launches} hand-written "
                             "kernels; its path has none")
    numbers = {"decode_step_p50_ms": statistics.median(step_ms),
               "decode_step_ms": step_ms, "decode_slots": LM_SLOTS,
               "max_seq": LM_MAX_SEQ, "layers": MOE_LAYERS,
               "forward_ms": fwd_ms, "forward_B": 1,
               "forward_T": LM_FORWARD_T,
               "forward_tokens_per_s": LM_FORWARD_T / fwd_ms * 1e3,
               "engine_tokens_per_s": tok_s, "peak_memory_GiB": peak,
               "step_device_kernels": kernels,
               "step_device_busy_ms": busy_ms,
               "step_device_busy_share": busy_ms / statistics.median(
                   step_ms),
               "step_bytes": step_values * (4 + 2 + 2),
               "step_byte_floor_ms":
                   step_values * (4 + 2 + 2) / HBM_BYTES_PER_S * 1e3,
               "step_byte_floor_bf16_weights_ms":
                   step_values * 2 / HBM_BYTES_PER_S * 1e3,
               "expert_share_of_step_bytes": expert_values / step_values,
               "train_layers": LM_CPU_LAYERS,
               "train_step_p50_ms": train_ms,
               "train_tokens_per_s": LM_TRAIN_B * LM_TRAIN_SEQ / train_ms
               * 1e3,
               "train_step_times_ms": [t * 1e3 for t in hist["step_time"]],
               "decode_vs_forward_rel": rel,
               "decode_vs_forward_rows": [int(clean.sum()),
                                          MOE_DECODE_B * LM_T],
               "decode_vs_forward_routed_apart": apart,
               "card_vs_cpu_rel": rels,
               "card_vs_cpu_routed_apart": n_apart,
               "kernel_launches": launches}
    log(f"lm moe (d) {MOE_ARCH} on {identity}: " + json.dumps(numbers))
    return numbers


def lm_vlm_card_vs_cpu(cfg):
    """The text logits of LM_CPU_B x LM_CPU_T tokens after the patches and
    one loss-and-gradient step at LM_CPU_LAYERS of full width, on the card
    and on the CPU, same weights."""
    import dataclasses

    from repro_torch import tree as tr
    from repro_torch.convert import model_params_to
    from repro_torch.models import Model
    from repro_torch.train import loss_and_grads
    small = dataclasses.replace(cfg, num_layers=LM_CPU_LAYERS)
    card = Model(small)
    params = card.init(torch.Generator(device="cuda").manual_seed(1))
    cpu = Model(small, device="cpu")
    cpu_params = model_params_to(params, "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        LM_CPU_B, LM_CPU_T + 1)).astype(np.int32))
    patches = torch.from_numpy(rng.standard_normal(
        (LM_CPU_B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    out = {}
    for dev, model, prm in (("cuda", card, params), ("cpu", cpu, cpu_params)):
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev),
                 "patches": patches.to(dev)}
        logits, _ = model.forward(prm, batch)
        loss, grads = loss_and_grads(model, prm, batch)
        out[dev] = (logits[:, cfg.num_patches:], loss, grads)
    (got, g_loss, g_card), (want, w_loss, g_cpu) = out["cuda"], out["cpu"]
    rels = {"text_logits": lm_rel(got, want),
            "loss": abs(g_loss.item() - w_loss.item()) / abs(w_loss.item()),
            "grads": max(lm_rel(a, b) for a, b in zip(tr.leaves(g_card),
                                                      tr.leaves(g_cpu)))}
    ties = lm_near_ties("vlm text logits", got, want)
    if (rels["text_logits"] > LM_TOL or rels["loss"] > LM_TOL
            or rels["grads"] > LM_GRAD_TOL):
        raise AssertionError(f"lm vlm: the card is off the CPU: {rels}")
    log(f"lm vlm (b) card == CPU at {LM_CPU_LAYERS} layers of full width, "
        f"{cfg.num_patches} patches before {LM_CPU_T} tokens, B = "
        f"{LM_CPU_B}: text logits rel {rels['text_logits']:.3g} (tolerance "
        f"{LM_TOL}; greedy picks equal, {ties} near ties), loss rel "
        f"{rels['loss']:.3g} ({LM_TOL}), every gradient leaf "
        f"{rels['grads']:.3g} ({LM_GRAD_TOL})")
    return rels


def lm_vlm_phase(identity: str):
    """The vlm family at internvl2-1b's whole published config: (a) the
    forward over VLM_PATCHES patch embeddings and VLM_T tokens, finite,
    and its time; (b) the card against the CPU at two layers; (c) the
    launcher's engine (text only) drains twice with the same tokens.  No
    hand-written kernel: every counter reads 0 after it."""
    from repro_torch import configs
    from repro_torch import tree as tr
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    counters = reset_counters()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(VLM_ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(v.numel() for v in tr.leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, not "
                             f"{cfg.param_count()}")
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, VLM_T)).astype(np.int32)).cuda(),
        "patches": torch.from_numpy(rng.standard_normal(
            (1, cfg.num_patches, cfg.d_model)).astype(np.float32)).cuda()}
    with torch.inference_mode():
        logits, _ = model.forward(params, batch)
        fwd_ms = time_ms(lambda: model.forward(params, batch), reps=5)
    if (logits.shape != (1, cfg.num_patches + VLM_T, cfg.vocab_size)
            or not torch.isfinite(logits.float()).all()):
        raise AssertionError(f"lm vlm: forward gave {logits.shape}")
    log(f"lm vlm (a) {VLM_ARCH} ({cfg.num_layers} layers, {n_params:,} "
        f"parameters): forward over {cfg.num_patches} patches and {VLM_T} "
        f"tokens, finite logits {tuple(logits.shape)}, {fwd_ms:.2f} ms")
    del model, params, logits, batch
    gc.collect()
    torch.cuda.empty_cache()
    rels = lm_vlm_card_vs_cpu(cfg)
    runs = [serve(VLM_ARCH, requests=LM_REQUESTS, slots=LM_SLOTS,
                  max_new_tokens=LM_NEW, full=True) for _ in range(2)]
    outs = [[r.output for r in reqs] for reqs, _ in runs]
    if not all(r.done and len(r.output) == LM_NEW for reqs, _ in runs
               for r in reqs) or outs[0] != outs[1]:
        raise AssertionError(f"lm vlm: the engine runs differ or did not "
                             f"drain: {outs}")
    launches = sum(fn.launches for fn in counters.values())
    if launches:
        raise AssertionError(f"lm vlm launched {launches} hand-written "
                             "kernels; its path has none")
    numbers = {"forward_ms": fwd_ms, "forward_patches": cfg.num_patches,
               "forward_T": VLM_T,
               "engine_tokens_per_s": [LM_REQUESTS * LM_NEW / s
                                       for _, s in runs],
               "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
               "card_vs_cpu_rel": rels, "kernel_launches": launches}
    log(f"lm vlm (c) ServeEngine drained {LM_REQUESTS} requests on "
        f"{LM_SLOTS} slots twice, same tokens: {outs[0]}")
    log(f"lm vlm (d) {VLM_ARCH} on {identity}: " + json.dumps(numbers))
    return numbers


def lake_phase():
    rng = np.random.default_rng(4)
    tables, queries, partners = make_lake(rng, LAKE_TABLES, QUERIES)
    rows = sum(len(k) for _, k, _ in tables)
    log(f"lake: {len(tables)} tables, {rows} rows")
    return tables, queries, partners


def reset_counters():
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def serve_queries(svc, lake):
    """The 64 queries through ``search_batch`` (micro-batches of 16) and
    through ``search``."""
    _, queries, _ = lake
    min_join = QUERY_ROWS / 4
    batched = svc.search_batch(queries, top_k=10, min_join=min_join,
                               micro_batch=MICRO_BATCH)
    sequential = [svc.search(k, v, top_k=10, min_join=min_join)
                  for k, v in queries]
    torch.cuda.synchronize()
    return batched, sequential


def check_served(label: str, family: str, svc, lake, batched, sequential,
                 launches, need):
    """Gates of a serving run: batched == sequential bit for bit, finite
    results, at least the launches ``need`` names, and for ICWS every
    planted partner in the top 10 (the other families' recall is printed,
    not gated: losing partners is the paper's finding).  Returns recall."""
    _, _, partners = lake
    d = svc.describe()
    log(f"{label} query p50 {d['query_ms_p50']:.2f} ms (search, "
        f"{d['queries_served']} queries); batch p50 {d['batch_ms_p50']:.2f} "
        f"ms (micro-batch of {MICRO_BATCH}, {d['batches_served']} batches; "
        f"{d['batched_query_ms_p50']:.2f} ms per query)")
    if sequential != batched:
        raise AssertionError(f"{label}: batched results differ from "
                             "sequential search")
    in_top, first = 0, 0
    for res, partner in zip(batched, partners):
        for r in res:
            if not (math.isfinite(r.join_size) and math.isfinite(r.corr)):
                raise AssertionError(f"{label}: non-finite result {r}")
        if partner is not None:
            names = [r.name for r in res]
            if family == "icws" and partner not in names:
                raise AssertionError(f"{label}: planted {partner} not in top "
                                     f"10: {names}")
            in_top += partner in names
            first += bool(names) and names[0] == partner
    returned = sum(len(res) for res in batched) / len(batched)
    log(f"{label} planted partners: {in_top} of {QUERIES // 2} in the top "
        f"10, {first} ranked first; {returned:.2f} tables returned per query "
        f"(each refined on the host); batched == sequential on {QUERIES} "
        f"queries")
    log(f"{label} launches on the serving run: {launches}")
    if any(launches[k] < n for k, n in need.items()):
        raise AssertionError(f"{label}: launch counters {launches} below "
                             f"{need}")
    return {"in_top10": in_top, "first": first, "planted": QUERIES // 2}


def log_store(label: str, svc, ingest: str):
    d = svc.describe()
    log(f"{label} {ingest}; store {d['corpus_rows']} rows x 3 fields, "
        f"capacity {d['corpus_capacity']}, {d['bytes_per_row']:.0f} B per "
        f"row, {3 * d['corpus_capacity'] * d['bytes_per_row'] / 1e6:.1f} MB"
        f"{', packed' if d['packed'] else ''}")


def service_phase(family: str, lake):
    """One family's service over the lake: ingest every table, answer the
    64 queries, with the launch counters set to 0 just before and read just
    after; the gates of :func:`check_served` and, for TS/PS, the stored
    rows' sorted-prefix layout.  Returns (launches, recall, service,
    (results, ingest seconds)): the results the merge phase compares its
    sharded build with."""
    from repro_torch import SketchSearchService
    tables = lake[0]
    svc = SketchSearchService(m=M, seed=0, family=family,
                              keep_host_oracle=False)
    counters = reset_counters()
    t0 = time.perf_counter()
    svc.ingest_many(tables)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    batched, sequential = serve_queries(svc, lake)
    launches = {name: fn.launches for name, fn in counters.items()}

    if family in ("ts", "ps"):
        from repro_torch.kernels.sample_estimate import sorted_prefix_ok
        if not sorted_prefix_ok(svc.index.store.buffers()[0]):
            raise AssertionError(f"{family}: stored rows break the "
                                 "sorted-prefix contract")
        log(f"{family}: every stored row keeps the sorted-prefix contract")
    log_store(family, svc, f"ingest: {LAKE_TABLES / ingest_s:.1f} tables/s "
              f"({ingest_s:.1f} s)")
    # one sketch launch per ingested table and per query batch or search
    # (none for TS/PS, built on the host), one estimate launch per batch or
    # search
    n_batches = math.ceil(QUERIES / MICRO_BATCH)
    *sketch_k, est_k = PATH_KERNELS[family]
    need = {k: LAKE_TABLES + n_batches + QUERIES for k in sketch_k}
    need[est_k] = n_batches + QUERIES
    recall = check_served(family, family, svc, lake, batched, sequential,
                          launches, need)
    return launches, recall, svc, (batched, ingest_s)


def carry(index, rows, *, packed: bool, mesh=None):
    """A port index over ``rows`` (one tensor per component, ``[3, size,
    ...]``) with ``index``'s tables, built by ``convert.index_from_numpy``
    (its rows split over ``mesh``'s corpus axis when given)."""
    from repro_torch.convert import index_from_numpy
    return index_from_numpy(
        [r.cpu().numpy() for r in rows], len(index.tables),
        tables=[(t.name, t.n_rows, (t.sample.hashes, t.sample.values))
                for t in index.tables],
        m=M, seed=0, family=index.family.name, packed=packed, mesh=mesh)


def b10_path_phase(index, tables):
    """B10's own path, the sketch-and-pack ingest of ``tables``: 16 tables'
    48 field rows per ``ops.*_sketch(pack_vals=True)`` launch, appended as
    they are to a packed store, which must equal ``index``'s first rows bit
    for bit.  Launch counters set to 0 just before and read just after;
    returns B10's launches."""
    from repro_torch.core.dmh import dmh_replication
    from repro_torch.data.ingest import pad_sparse_batch
    from repro_torch.data.store import CorpusStore
    from repro_torch.kernels import ops
    dev = index.device
    fam = index.family
    store = CorpusStore(family=fam, fields=3, packed=True, device=dev)
    sketch = (ops.icws_sketch if fam.name == "icws" else functools.partial(
        ops.dmh_sketch, replicas=dmh_replication(M)))
    counters = reset_counters()
    for lo in range(0, len(tables), 16):
        vecs = [v for _, k, x in tables[lo:lo + 16]
                for v in index.vectorize(k, x)]
        w, keys, vals, norms = pad_sparse_batch(vecs)
        fp, _, _, _, words = sketch(
            *(torch.from_numpy(a).to(dev) for a in (w, keys, vals)), m=M,
            seed=0, pack_vals=True)
        norms = torch.from_numpy(norms.astype(np.float32)).to(dev)
        store.append_packed(*(x.reshape((-1, 3) + tuple(x.shape[1:]))
                              .transpose(0, 1) for x in (fp, words, norms)))
    torch.cuda.synchronize()
    launches = counters[B10_PATH_KERNEL[fam.name]].launches
    n = len(tables)
    for got, want in zip(store.buffers(), index.store.buffers()):
        if not bits_equal(got[:, :n], want[:, :n]):
            raise AssertionError(f"{fam.name}: the sketch-and-pack ingest "
                                 "differs from the packed service's rows")
    if launches < math.ceil(n / 16):
        raise AssertionError(f"{fam.name}: sketch-and-pack ingest launched "
                             f"{B10_PATH_KERNEL[fam.name]} {launches} times")
    log(f"{fam.name} sketch-and-pack ingest (B10, ops.{fam.name}_sketch("
        f"pack_vals=True)) of {n} tables equals the packed service's rows "
        f"bit for bit; {launches} launches of {B10_PATH_KERNEL[fam.name]}")
    return launches


def roundtrip_check(label: str, svc, lake, sequential):
    """Every estimate of the 64 queries (in micro-batches of 16) and every
    ``search`` result equal, bit for bit, those of an unpacked index over
    the bf16-roundtripped rows."""
    _, queries, _ = lake
    idx = svc.index
    size = len(idx.store)
    ref = carry(idx, idx.family.unpack_rows(
        tuple(b[:, :size] for b in idx.store.buffers())), packed=False)
    for lo in range(0, len(queries), MICRO_BATCH):
        chunk = queries[lo:lo + MICRO_BATCH]
        vecs = [v for k, x in chunk for v in idx.vectorize(k, x)]
        q = tuple(c.reshape((len(chunk), 3) + tuple(c.shape[1:]))
                  .transpose(0, 1)
                  for c in idx.family.sketch_rows(vecs, device=idx.device))
        got = idx._estimate(q, idx.store.buffers())[:, :, :size]
        want = ref._estimate(q, ref.store.buffers())[:, :, :size]
        if not bits_equal(got, want):
            raise AssertionError(f"{label}: estimates differ from the "
                                 "unpacked index over the roundtripped rows")
    min_join = QUERY_ROWS / 4
    if [ref.query(k, v, top_k=10, min_join=min_join)
            for k, v in queries] != sequential:
        raise AssertionError(f"{label}: results differ from the unpacked "
                             "index over the roundtripped rows")
    log(f"{label}: every estimate and result equals the unpacked index over "
        f"the roundtripped rows bit for bit ({len(queries)} queries)")


def packed_service_phase(family: str, lake, unpacked):
    """One family's packed service (``packed=True``) over the lake, launch
    counters set to 0 just before and read just after: ICWS ingests every
    table through ``ingest_many``; the other families fill their packed
    index from the rows the unpacked run sketched (``family.pack_rows``,
    ``convert.index_from_numpy(packed=True)``); then the 64 queries.
    Gates: :func:`check_served` and :func:`roundtrip_check`.  Returns
    (launches, recall, service, results)."""
    from repro_torch import SketchSearchService
    label = f"{family} packed"
    tables = lake[0]
    counters = reset_counters()
    t0 = time.perf_counter()
    svc = SketchSearchService(m=M, seed=0, family=family, packed=True,
                              keep_host_oracle=False)
    if family == "icws":
        svc.ingest_many(tables)
    else:
        src = unpacked.index
        size = len(src.store)
        svc.index = carry(src, src.family.pack_rows(
            tuple(b[:, :size] for b in src.store.buffers())), packed=True)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    batched, sequential = serve_queries(svc, lake)
    launches = {name: fn.launches for name, fn in counters.items()}
    log_store(label, svc, (f"ingest: {LAKE_TABLES / ingest_s:.1f} tables/s"
                           if family == "icws" else "filled from the "
                           "unpacked run's rows") + f" ({ingest_s:.1f} s)")
    d = unpacked.describe()
    log(f"{label}: unpacked store {d['bytes_per_row']:.0f} B per row, "
        f"{3 * d['corpus_capacity'] * d['bytes_per_row'] / 1e6:.1f} MB")
    n_batches = math.ceil(QUERIES / MICRO_BATCH)
    need = {k: n_batches + QUERIES for k in PACKED_PATH_KERNELS[family]}
    if family == "icws":
        need["icws_sketch"] += LAKE_TABLES
    recall = check_served(label, family, svc, lake, batched, sequential,
                          launches, need)
    roundtrip_check(label, svc, lake, sequential)
    return launches, recall, svc, batched


def latency_phase(family: str, lake, unpacked, packed):
    """``search`` and micro-batch latency of the family's unpacked (A) and
    packed (B) service in the turns of ``LATENCY_ORDER``, the two services
    alone in the process: each turn answers the 64 queries one by one and
    in micro-batches of 16.  Returns the p50s in ms, per store."""
    _, queries, _ = lake
    min_join = QUERY_ROWS / 4
    times = {"A": ([], []), "B": ([], [])}
    turn_p50 = []
    for turn in LATENCY_ORDER:
        svc = unpacked if turn == "A" else packed
        one, batch = times[turn]
        for k, v in queries:
            t0 = time.perf_counter()
            svc.search(k, v, top_k=10, min_join=min_join)
            one.append(time.perf_counter() - t0)
        for lo in range(0, len(queries), MICRO_BATCH):
            t0 = time.perf_counter()
            svc.search_batch(queries[lo:lo + MICRO_BATCH], top_k=10,
                             min_join=min_join, micro_batch=MICRO_BATCH)
            batch.append(time.perf_counter() - t0)
        turn_p50.append(statistics.median(one[-len(queries):]) * 1e3)
    p50 = {store: {"search_ms": statistics.median(one) * 1e3,
                   "batch_ms": statistics.median(batch) * 1e3,
                   "searches": len(one), "batches": len(batch)}
           for store, (one, batch) in (("unpacked", times["A"]),
                                       ("packed", times["B"]))}
    log(f"{family} latency, turns {LATENCY_ORDER} (A unpacked, B packed): "
        + "; ".join(f"{store} search p50 {r['search_ms']:.3f} ms "
                    f"({r['searches']}), micro-batch p50 {r['batch_ms']:.3f} "
                    f"ms ({r['batches']})" for store, r in p50.items())
        + "; search p50 per turn " + " ".join(
            f"{t}:{ms:.3f}" for t, ms in zip(LATENCY_ORDER, turn_p50)))
    return p50


# the ops (``repro_torch.kernels.ops``) through which each kernel wrapper
# is launched on the serving path: a sketch op launches its kernel or,
# with pack_vals=True, the packed twin; the ICWS/DMH estimate is an outer
# op around an inner one, and both count each launch
OP_KERNELS = {
    "icws_sketch": ("icws_sketch", "icws_sketch_packed"),
    "dmh_sketch": ("dmh_sketch", "dmh_sketch_packed"),
    "countsketch_sparse": ("countsketch_sparse",),
    "jl_sketch": ("jl_sketch",),
    "icws_estimate_fields": ("estimate_fields",),
    "estimate_partials_fields": ("estimate_fields",),
    "icws_estimate_fields_packed": ("estimate_fields_packed",),
    "linear_estimate_fields": ("linear_estimate_fields",),
    "linear_estimate_fields_packed": ("linear_estimate_fields_packed",),
    "sample_estimate_fields": ("sample_estimate_fields",),
    "sample_estimate_fields_packed": ("sample_estimate_fields_packed",)}
# the disabled wrapper's cost, as benchmarks/perf_sketch.py gates it: at
# most 2% of the search p50, over this many calls
OBS_WRAPPER_CALLS = 10_000
OBS_OVERHEAD_GATE = 0.02


def disabled_wrapper_s() -> float:
    """Seconds a call that the disabled ``@instrumented`` wrapper adds to
    a bare function, over ``OBS_WRAPPER_CALLS`` calls of each."""
    from repro_torch import obs

    def bare():
        return None

    wrapped = obs.instrumented("icws_estimate")(bare)
    times = []
    for fn in (wrapped, bare):
        t0 = time.perf_counter()
        for _ in range(OBS_WRAPPER_CALLS):
            fn()
        times.append((time.perf_counter() - t0) / OBS_WRAPPER_CALLS)
    return max(times[0] - times[1], 0.0)


def obs_search_turns(svc, lake):
    """The 64 searches with observability off (A) and on (B) in turns A B
    B A.  Returns each side's p50 in ms, per-turn p50s, and the ops
    launches a search made while on."""
    from repro_torch import obs
    _, queries, _ = lake
    min_join = QUERY_ROWS / 4
    times = {"A": [], "B": []}
    turn_p50 = []
    obs.reset_all()
    for turn in "ABBA":
        (obs.enable if turn == "B" else obs.disable)()
        for k, v in queries:
            t0 = time.perf_counter()
            svc.search(k, v, top_k=10, min_join=min_join)
            times[turn].append(time.perf_counter() - t0)
        turn_p50.append(statistics.median(times[turn][-len(queries):]) * 1e3)
    obs.disable()
    series = obs.describe_metrics()["metrics"]["ops.launches_total"]["series"]
    per_search = sum(s["value"] for s in series) / len(times["B"])
    return ({t: statistics.median(x) * 1e3 for t, x in times.items()},
            turn_p50, per_search)


def observability_phase(family: str, lake, unpacked, packed):
    """With observability on, the 64 queries again on both endpoints of
    the family's unpacked and packed services (``unpacked`` and ``packed``
    are (service, results of its serving run)), launch counters and the
    metrics set to 0 just before and read just after.  Gates: the results
    equal the serving runs' bit for bit; each op's ``ops.launches_total``
    equals the launches of the kernels it reaches (``OP_KERNELS``) and
    every launched kernel is counted by an op; ``ops.interpret_mode`` reads
    0.  For ICWS, the ``search`` p50 with observability off and on in turns
    A B B A, and the disabled wrapper's cost under 2% of the off p50.
    Prints the trace events and the size of an ``export_snapshot``."""
    from repro_torch import obs
    counters = reset_counters()
    obs.reset_all()
    obs.enable()
    try:
        for label, (svc, want) in (("unpacked", unpacked),
                                   ("packed", packed)):
            batched, sequential = serve_queries(svc, lake)
            if batched != want or sequential != want:
                raise AssertionError(f"{family} {label}: results with "
                                     "observability on differ from the "
                                     "serving run's")
        launches = {name: fn.launches for name, fn in counters.items()}
        snap = obs.describe_metrics()["metrics"]
        n_events = len(obs.events())
        with tempfile.TemporaryDirectory() as tmp:
            paths = obs.export_snapshot(tmp)
            snap_bytes = {k: pathlib.Path(p).stat().st_size
                          for k, p in paths.items()}
    finally:
        obs.disable()
    ops = {}
    for s in snap["ops.launches_total"]["series"]:
        if s["labels"]["family"] != family:
            raise AssertionError(f"{family}: a launch counted under "
                                 f"{s['labels']}")
        ops[s["labels"]["op"]] = ops.get(s["labels"]["op"], 0) + s["value"]
    for op, n in ops.items():
        if op not in OP_KERNELS:
            raise AssertionError(f"{family}: op {op} reaches no kernel of "
                                 "the serving path")
        want_n = sum(launches[k] for k in OP_KERNELS[op])
        if n != want_n:
            raise AssertionError(f"{family}: ops.launches_total{{op={op}}} "
                                 f"{n} != its kernels' launches {want_n}")
    for k, n in launches.items():
        if n and not any(k in OP_KERNELS[op] for op in ops):
            raise AssertionError(f"{family}: {n} launches of {k} counted "
                                 "by no op")
    mode = snap["ops.interpret_mode"]["series"][0]["value"]
    if mode != 0.0:
        raise AssertionError(f"{family}: ops.interpret_mode {mode}, not 0")
    searches = snap["serve.queries_total"]["series"][0]["value"]
    log(f"observability {family}: results on both endpoints of both "
        f"services equal the serving runs' bit for bit; ops.launches_total "
        f"{json.dumps(ops, sort_keys=True)} equal to the kernels' launches "
        f"{json.dumps({k: n for k, n in launches.items() if n})}; "
        f"interpret_mode {mode}; {searches} searches; {n_events} trace "
        f"events; export_snapshot {sum(snap_bytes.values())} B "
        f"{json.dumps(snap_bytes, sort_keys=True)}")
    if family != "icws":
        return None
    p50, turn_p50, per_search = obs_search_turns(unpacked[0], lake)
    wrapper_s = disabled_wrapper_s()
    share = wrapper_s * per_search / (p50["A"] / 1e3)
    log(f"observability icws: search p50 off {p50['A']:.3f} ms, on "
        f"{p50['B']:.3f} ms (turns A B B A, {QUERIES} searches a turn: "
        + " ".join(f"{t}:{ms:.3f}" for t, ms in zip("ABBA", turn_p50))
        + f"); disabled wrapper {wrapper_s * 1e9:.1f} ns a call x "
        f"{per_search:g} launches a search = {100 * share:.4f}% of the off "
        f"p50 (gate {100 * OBS_OVERHEAD_GATE:g}%)")
    if share >= OBS_OVERHEAD_GATE:
        raise AssertionError(f"disabled observability costs {share:.2%} of "
                             "a search")


def cuda_mesh(shards: int):
    """A ``shards``-way corpus axis over the one card, repeated."""
    from repro_torch.launch import make_corpus_mesh
    return make_corpus_mesh(devices=("cuda:0",) * shards)


def search_turns(services, lake):
    """``search`` p50 (ms) of each service of ``services`` (by turn
    letter), the 64 queries a turn, in the turns of ``SHARDED_TURNS``."""
    _, queries, _ = lake
    times = {t: [] for t in services}
    for turn in SHARDED_TURNS:
        for k, v in queries:
            t0 = time.perf_counter()
            services[turn].search(k, v, top_k=10, min_join=QUERY_ROWS / 4)
            times[turn].append(time.perf_counter() - t0)
    return {t: statistics.median(x) * 1e3 for t, x in times.items()}


def pad_path_check(index, lake):
    """The ICWS fields launch on the single-device store's raw buffers
    through ``ops.icws_estimate_fields_sharded`` over 3 shards (the op's
    pad path: 16,384 rows padded to 16,386) equals the single launch bit
    for bit, for the first micro-batch of queries."""
    from repro_torch.data.dataset_search import CFIELD, QFIELD
    from repro_torch.kernels import ops
    _, queries, _ = lake
    chunk = queries[:MICRO_BATCH]
    vecs = [v for k, x in chunk for v in index.vectorize(k, x)]
    q = tuple(c.reshape((len(chunk), 3) + tuple(c.shape[1:])).transpose(0, 1)
              for c in index.family.sketch_rows(vecs, device=index.device))
    size = len(index.store)
    bufs = tuple(b[:, :size] for b in index.store.buffers())
    want = index._estimate(q, bufs)
    got = ops.icws_estimate_fields_sharded(*q[:3], *bufs[:3], qmap=QFIELD,
                                           cmap=CFIELD, mesh=cuda_mesh(3),
                                           axis="data")
    if got.shape != want.shape or not bits_equal(got, want):
        raise AssertionError("icws: the 3-shard fields launch on the pad "
                             "path differs from the single launch")
    log(f"icws sharded pad path: ops.icws_estimate_fields_sharded over 3 "
        f"shards of {size} rows ({-(-size // 3)} a shard) equals the single "
        f"launch bit for bit ({tuple(got.shape)})")


def sharded_phase(family: str, lake, unpacked, packed):
    """The family's sharded serving, for its unpacked and its packed
    service (each ``(service, results of its serving run)``): a port
    index over the rows the service holds (``convert.index_from_numpy(
    mesh=...)``: no second ingest), split over ``SHARDS[0]`` shards of the
    card (ICWS also ``SHARDS[1]``), behind ``SketchSearchService(mesh=
    ...)``; its 64 queries through ``search`` and ``search_batch`` (micro-
    batches of 16), launch counters set to 0 just before and read just
    after.  Gates: the results equal the single-device service's (``==``);
    the estimate kernel launched once a shard a call.  Then the ``search``
    p50 of the single-device (A) and 2-shard (B) services in turns
    ``SHARDED_TURNS``.  Returns (launches summed over the sharded runs,
    p50s)."""
    from repro_torch import SketchSearchService
    n_calls = math.ceil(QUERIES / MICRO_BATCH) + QUERIES
    total = dict.fromkeys(launch_counters(), 0)
    p50 = {}
    for label, is_packed, (svc, want) in (("unpacked", False, unpacked),
                                          ("packed", True, packed)):
        src = svc.index
        rows = tuple(b[:, :len(src.store)] for b in src.store.buffers())
        est_k = (PACKED_PATH_KERNELS if is_packed else PATH_KERNELS)[
            family][-1]
        for shards in SHARDS if family == "icws" else SHARDS[:1]:
            mesh = cuda_mesh(shards)
            sharded = SketchSearchService(m=M, seed=0, family=family,
                                          packed=is_packed,
                                          keep_host_oracle=False, mesh=mesh)
            sharded.index = carry(src, rows, packed=is_packed, mesh=mesh)
            counters = reset_counters()
            batched, sequential = serve_queries(sharded, lake)
            launches = {k: fn.launches for k, fn in counters.items()}
            if batched != want or sequential != want:
                raise AssertionError(f"{family} {label} over {shards} "
                                     "shards: results differ from the "
                                     "single-device service")
            if launches[est_k] != shards * n_calls:
                raise AssertionError(f"{family} {label} over {shards} "
                                     f"shards: {launches[est_k]} launches of "
                                     f"{est_k}, not {shards * n_calls}")
            for k, n in launches.items():
                total[k] += n
            store = sharded.index.store
            log(f"sharded {family} {label}, {shards} shards of "
                f"{store.capacity // shards} rows on cuda:0: search and "
                f"search_batch results == the single-device service's "
                f"({QUERIES} queries); {est_k} launched {launches[est_k]} "
                "times (once a shard a call)")
            if shards == SHARDS[0]:
                p50[label] = search_turns({"A": svc, "B": sharded}, lake)
            del sharded
        if family == "icws" and not is_packed:
            pad_path_check(src, lake)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"sharded {family} search p50 ms, turns {SHARDED_TURNS} (A single "
        f"device, B {SHARDS[0]} shards), {QUERIES} searches a turn: "
        + "; ".join(f"{label} A {r['A']:.3f} B {r['B']:.3f}"
                    for label, r in p50.items()) + f" on {card_identity()}")
    return total, p50


def family_phases(family: str, lake):
    """The family's unpacked and packed serving runs, their latency turns,
    the observability replay, the sharded serving runs and, for ICWS and
    DMH, B10's path; then both
    services are freed, so each family runs with no other family's service
    alive."""
    launches, recall, svc, served = phase(f"service {family}",
                                          service_phase, family, lake)
    p_launches, p_recall, p_svc, p_served = phase(
        f"service packed {family}", packed_service_phase, family, lake, svc)
    latency = phase(f"latency {family}", latency_phase, family, lake, svc,
                    p_svc)
    phase(f"observability {family}", observability_phase, family, lake,
          (svc, served[0]), (p_svc, p_served))
    sharded = phase(f"sharded {family}", sharded_phase, family, lake,
                    (svc, served[0]), (p_svc, p_served))
    b10 = (phase(f"sketch-and-pack ingest {family}", b10_path_phase,
                 p_svc.index, lake[0][:B10_TABLES])
           if family in B10_PATH_KERNEL else None)
    del svc, p_svc
    gc.collect()
    torch.cuda.empty_cache()
    return ((launches, recall), (p_launches, p_recall), latency, b10,
            sharded)


def sub_lake(lake):
    """The merge phase's sub-lake: the planted partners and the lake's
    first ``MERGE_SUBLAKE - 32`` other tables, in lake order."""
    tables = lake[0]
    partners = {p for p in lake[2] if p is not None}
    others = iter(range(MERGE_SUBLAKE - len(partners)))
    return [t for t in tables
            if t[0] in partners or next(others, None) is not None]


def first_ranked(label: str, results, partners):
    """Gate: every planted partner ranks first.  Returns the count."""
    first = sum(bool(res) and res[0].name == p
                for res, p in zip(results, partners) if p is not None)
    planted = sum(p is not None for p in partners)
    for res in results:
        for r in res:
            if not (math.isfinite(r.join_size) and math.isfinite(r.corr)):
                raise AssertionError(f"{label}: non-finite result {r}")
    if first != planted:
        raise AssertionError(f"{label}: {first} of {planted} planted "
                             "partners ranked first")
    return first


def top10_overlap(results, reference):
    """Per query, the tables two top-10 lists share and the reference
    list's length (``min_join`` leaves most lists short)."""
    return [(len({r.name for r in a} & {r.name for r in b}), len(b))
            for a, b in zip(results, reference)]


def sharded_service(family: str, tables, queries):
    """A service that ingests ``tables`` through ``ingest_many_sharded``
    (``MERGE_SHARDS`` shards) and answers ``queries`` in micro-batches of
    16, the launch counters set to 0 just before the ingest and read just
    after the queries.  Returns (service, results, launches, ingest s)."""
    from repro_torch import SketchSearchService
    svc = SketchSearchService(m=M, seed=0, family=family,
                              keep_host_oracle=False)
    counters = reset_counters()
    t0 = time.perf_counter()
    svc.ingest_many_sharded(tables, shards=MERGE_SHARDS)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    results = svc.search_batch(queries, top_k=10, min_join=QUERY_ROWS / 4,
                               micro_batch=MICRO_BATCH)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    *sketch_k, est_k = PATH_KERNELS[family]
    need = {k: 3 * MERGE_SHARDS for k in sketch_k}
    need[est_k] = math.ceil(len(queries) / MICRO_BATCH)
    if any(launches[k] < n for k, n in need.items()):
        raise AssertionError(f"{family} sharded build: launch counters "
                             f"{launches} below {need}")
    return svc, results, launches, ingest_s


def integer_lake(rng):
    """A separated lake of ``INT_LAKE_TABLES`` integer-valued tables of
    500-2,000 rows (``tests/test_merge.py``'s lake at depth): 8
    near-duplicates of an integer signal and disjoint-key noise tables,
    every value a non-zero integer, so that CountSketch shard tables add
    exactly in f32.  Returns (tables, queries)."""
    signal = rng.integers(1, 9, 2_000) * rng.choice([-1.0, 1.0], 2_000)
    tables = []
    for i in range(8):
        n = 1_000 + 125 * i
        tables.append((f"dup{i}", np.arange(n),
                       signal[:n] + rng.integers(10, 13, n)))
    for i in range(INT_LAKE_TABLES - 8):
        n = int(rng.integers(500, 2_001))
        lo = 10_000 + 2_000 * i
        tables.append((f"far{i:03d}", np.arange(lo, lo + n),
                       rng.integers(1, 9, n) * rng.choice([-1.0, 1.0], n)))
    queries = [(np.arange(1_000), signal[:1_000]),
               (np.arange(500, 1_500), signal[500:1_500]),
               (np.arange(12_000, 12_400),
                rng.integers(1, 9, 400) * rng.choice([-1.0, 1.0], 400))]
    return tables, queries


def shard_rows(family, vec_rows, shard: int, shards: int):
    """The family's ``[3, B, ...]`` rows of shard ``shard`` of each row's
    three field vectors, on the card."""
    from repro_torch.data.merge import split_by_key
    per_field = [family.sketch_rows([split_by_key(r[f], shards, shard)
                                     for r in vec_rows])
                 for f in range(3)]
    return tuple(torch.stack([c[i] for c in per_field])
                 for i in range(len(family.components)))


def merge_rows_checks(name: str, family, a, b):
    """``merge_rows(a, b)`` equals ``merge_rows(b, a)`` bit for bit; for
    ICWS and DMH, fingerprints and argkeys on at least 99% of slots equal
    the port's host ``merge`` on the same rows.  Returns the slots that
    differ (0 for the other families)."""
    from repro_torch.core.icws import ICWSSketch
    ab, ba = family.merge_rows(a, b), family.merge_rows(b, a)
    for x, y, spec in zip(ab, ba, family.components):
        if not bits_equal(x, y):
            raise AssertionError(f"{name}: merge_rows(a, b) != merge_rows(b, "
                                 f"a) in {spec.name}")
    if name not in ("icws", "dmh"):
        return {"fp": 0, "argkey": 0, "slots": int(ab[0].numel())}
    host = family.host_oracle()
    fp, val, norm, key = (x.cpu().numpy() for x in ab)
    (fpa, va, na, ka), (fpb, vb, nb, kb) = (
        [x.cpu().numpy() for x in r] for r in (a, b))
    diff_fp = diff_key = 0
    for f in range(fp.shape[0]):
        for i in range(fp.shape[1]):
            ref = host.merge(
                ICWSSketch(fpa[f, i], va[f, i].astype(np.float64),
                           float(na[f, i]), ka[f, i]),
                ICWSSketch(fpb[f, i], vb[f, i].astype(np.float64),
                           float(nb[f, i]), kb[f, i]))
            diff_fp += int(np.sum(ref.fingerprints != fp[f, i]))
            diff_key += int(np.sum(ref.argkeys != key[f, i]))
    slots = int(fp.size)
    if diff_fp > 0.01 * slots or diff_key > 0.01 * slots:
        raise AssertionError(f"{name}: the card's merge differs from the host "
                             f"merge on {diff_fp} fingerprints and {diff_key} "
                             f"argkeys of {slots} slots")
    return {"fp": diff_fp, "argkey": diff_key, "slots": slots}


def merge_stores_ms(family, a, b) -> float:
    """``merge_stores`` of two ``MERGE_ROWS``-row, 3-field stores holding
    ``a`` and ``b`` (shard rows) tiled to that depth, in ms by CUDA events
    (the TS/PS merge runs on the host, inside the events)."""
    from repro_torch.data.merge import merge_stores
    from repro_torch.data.store import CorpusStore
    reps = MERGE_ROWS // a[0].shape[1]
    stores = []
    for rows in (a, b):
        store = CorpusStore(family=family, fields=3)
        store.append(*(torch.cat([r] * reps, dim=1) for r in rows))
        stores.append(store)
    host = family.name in ("ts", "ps")
    return time_ms(lambda: merge_stores(*stores), reps=1 if host else 3,
                   warmup=0 if host else 1)


def merge_phase(lake):
    """Mergeable corpora on the card, m = 512, unpacked, 4 shards.  Each
    family ingests the sub-lake through ``ingest_many_sharded``, with a
    single-stream service of it beside; every planted partner must rank
    first, and each query's top 10
    is printed against the single-stream service's.  On the integer lake
    the CS sharded build answers exactly as the single-stream one and JL
    within rtol 1e-5.  Per family ``merge_rows`` commutes bit for bit (ICWS
    and DMH within 1% of slots of the host merge) and ``merge_stores`` is
    timed.  Returns the sharded builds' launches, summed."""
    from repro_torch import SketchSearchService
    from repro_torch.data.dataset_search import DatasetSearchIndex
    _, queries, partners = lake
    min_join = QUERY_ROWS / 4
    launches = {name: 0 for name in launch_counters()}
    report = {}
    sub = sub_lake(lake)
    vectorize = DatasetSearchIndex(m=M, seed=0,
                                   keep_host_oracle=False).vectorize
    vec_rows = [vectorize(k, x) for _, k, x in sub[:MERGE_ROWS // 8]]
    for family in FAMILIES:
        t0 = time.perf_counter()
        single = SketchSearchService(m=M, seed=0, family=family,
                                     keep_host_oracle=False)
        t1 = time.perf_counter()
        single.ingest_many(sub)
        torch.cuda.synchronize()
        ref_ingest_s = time.perf_counter() - t1
        ref = single.search_batch(queries, top_k=10, min_join=min_join,
                                  micro_batch=MICRO_BATCH)
        del single
        svc, results, run, ingest_s = sharded_service(family, sub, queries)
        for k, n in run.items():
            launches[k] += n
        first = first_ranked(f"{family} sharded", results, partners)
        ref_first = sum(bool(r) and r[0].name == p
                        for r, p in zip(ref, partners) if p is not None)
        overlap = top10_overlap(results, ref)
        shared = sum(o for o, _ in overlap)
        returned = sum(n for _, n in overlap)
        n = len(sub)
        log(f"{family} sharded build ({MERGE_SHARDS} shards, {n} tables): "
            f"{n / ingest_s:.1f} tables/s ({ingest_s:.1f} s) against "
            f"ingest_many's {n / ref_ingest_s:.1f} tables/s; planted "
            f"partners ranked first {first} of {QUERIES // 2} (single-stream "
            f"{ref_first}); top-10 overlap with the single-stream service "
            f"{shared} of its {returned} results, per query (shared, its "
            f"count) {overlap}; launches {run}")
        del svc
        fam = family_for(family)
        a, b = (shard_rows(fam, vec_rows, s, 2) for s in (0, 1))
        diff = merge_rows_checks(
            family, fam, *(tuple(c[:, :MERGE_CHECK_TABLES] for c in r)
                           for r in (a, b)))
        ms = merge_stores_ms(fam, a, b)
        del a, b
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{family} merge_rows commutes bit for bit"
            + (f"; against the host merge {diff['fp']} fingerprints and "
               f"{diff['argkey']} argkeys of {diff['slots']} slots differ"
               if family in ("icws", "dmh") else "")
            + f"; merge_stores of two {MERGE_ROWS}-row, 3-field stores "
            f"{ms:.3f} ms")
        report[family] = {"sharded_tables_per_s": n / ingest_s,
                          "ingest_many_tables_per_s": n / ref_ingest_s,
                          "tables": n, "first": first,
                          "top10_shared": shared,
                          "top10_single_stream": returned,
                          "merge_stores_ms": ms, "host_merge_diff": diff,
                          "s": time.perf_counter() - t0}
    int_tables, int_queries = integer_lake(np.random.default_rng(9))
    for family in ("cs", "jl"):
        single = SketchSearchService(m=M, seed=0, family=family,
                                     keep_host_oracle=False)
        single.ingest_many(int_tables)
        sharded = SketchSearchService(m=M, seed=0, family=family,
                                      keep_host_oracle=False)
        sharded.ingest_many_sharded(int_tables, shards=MERGE_SHARDS)
        kw = dict(top_k=4, min_join=20)
        got = sharded.search_batch(int_queries, **kw)
        want = single.search_batch(int_queries, **kw)
        for g, w in zip(got, want):
            if [r.name for r in g] != [r.name for r in w]:
                raise AssertionError(f"{family} integer lake: sharded names "
                                     f"{[r.name for r in g]} != {[r.name for r in w]}")
            for x, y in zip(g, w):
                sx = [x.join_size, x.sum_b, x.mean_b, x.corr]
                sy = [y.join_size, y.sum_b, y.mean_b, y.corr]
                ok = (sx == sy if family == "cs" else
                      np.allclose(sx, sy, rtol=1e-5, atol=1e-5))
                if not ok:
                    raise AssertionError(f"{family} integer lake: {x} != {y}")
        log(f"{family} integer lake ({len(int_tables)} tables): the sharded "
            "build answers " + ("exactly as" if family == "cs" else
                                "within rtol 1e-5 of")
            + f" the single-stream build, top {[r.name for r in got[0]]}")
        del single, sharded
    log("merge (" + card_identity() + "): " + json.dumps(report))
    return launches


def host_oracle_phase(lake):
    """An ICWS service that keeps its host WeightedMinHash sketches
    (``keep_host_oracle=True``) over the first 6 planted partners and 6
    other tables under 2,000 rows, queried with the partners' queries on
    both backends: the same top-3 names, the partner first in both, and
    equal ``corr`` (the KMV refinement is shared).  The service audits
    every search (``audit_every=1``), which does nothing while
    observability is off; then, with it on, the partner queries again:
    the same results as the device searches without it, and the audit's
    samples (``quality.samples_total``, ``quality.ppm_error``)."""
    from repro_torch import SketchSearchService, obs
    tables, queries, partners = lake
    by_name = {t[0]: t for t in tables}
    picked = [(qi, p) for qi, p in enumerate(partners)
              if p is not None][:HOST_TABLES]
    others = [t for t in tables if not t[0].startswith("partner")
              and len(t[1]) < 2_000][:HOST_TABLES]
    svc = SketchSearchService(m=M, seed=0, family="icws",
                              keep_host_oracle=True, audit_every=1)
    t0 = time.perf_counter()
    svc.ingest_many([by_name[p] for _, p in picked] + others)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    min_join = QUERY_ROWS / 4
    host_s = 0.0
    device_results = []
    for qi, partner in picked:
        dev = svc.search(*queries[qi], top_k=3, min_join=min_join)
        device_results.append(dev)
        t1 = time.perf_counter()
        host = svc.search(*queries[qi], top_k=3, min_join=min_join,
                          backend="host")
        host_s += time.perf_counter() - t1
        if [r.name for r in dev] != [r.name for r in host]:
            raise AssertionError(f"host oracle: device top 3 "
                                 f"{[r.name for r in dev]} != host "
                                 f"{[r.name for r in host]}")
        if not dev or dev[0].name != partner:
            raise AssertionError(f"host oracle: {partner} not first "
                                 f"({[r.name for r in dev]})")
        if [r.corr for r in dev] != [r.corr for r in host]:
            raise AssertionError("host oracle: corr differs between the "
                                 "backends")
    d = svc.describe()
    log(f"host oracle: {d['tables']} tables ingested with their host "
        f"sketches in {ingest_s:.1f} s; {len(picked)} partner queries on "
        f"both backends: equal top-3 names and corr, each partner first; "
        f"host search {1e3 * host_s / len(picked):.1f} ms a query")
    obs.reset_all()
    obs.enable()
    try:
        t0 = time.perf_counter()
        for (qi, _), want in zip(picked, device_results):
            if svc.search(*queries[qi], top_k=3,
                          min_join=min_join) != want:
                raise AssertionError("host oracle: an audited search "
                                     "differs from the device search")
        audit_s = time.perf_counter() - t0
        samples = obs.counter("quality.samples_total", family="icws").value
        ppm = obs.gauge("quality.ppm_error", family="icws").value
    finally:
        obs.disable()
    if samples <= 0:
        raise AssertionError("host oracle: the audit recorded no sample")
    log(f"host oracle audit (audit_every=1, observability on): "
        f"{len(picked)} searches equal the device searches without it; "
        f"quality.samples_total{{icws}} {samples}, quality.ppm_error{{icws}} "
        f"{ppm:.1f} ppm (EWMA of |device - host| / host join size); "
        f"{1e3 * audit_s / len(picked):.1f} ms a search with its audit")


def same_sketch(a, b) -> bool:
    """Two host sketches equal field by field, array for array."""
    fa, fb = vars(a), vars(b)
    return fa.keys() == fb.keys() and all(
        np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def sketch_agreement(what, got, want) -> float:
    """The share of slots whose fingerprints agree between a card ICWS
    sketch ``(fp, val, norm, argkey)`` and the plain version's, with the
    kernel phase's gate: at least 0.99, values and argkeys equal where they
    agree, norms equal."""
    got = [x.cpu() for x in got]
    agree = got[0] == want[0]
    share = agree.float().mean().item()
    if share < 0.99 or not (bits_equal(got[1][agree], want[1][agree])
                            and torch.equal(got[3][agree], want[3][agree])
                            and bits_equal(got[2], want[2])):
        raise AssertionError(f"paper baselines: {what}: fingerprints agree "
                             f"on {share:.4f} of slots (gate 0.99), or the "
                             "values, argkeys or norms differ where they do")
    return share


def baseline_identities(v):
    """The identities the paper baselines phase stops on (exact laws, not
    accuracy): MH and KMV ``merge_union`` of ``v``'s two disjoint halves is
    the sketch of ``v``; the f64 JL and CountSketch ``merge`` of the halves
    is the sketch of ``v`` within 1e-12 of the table's largest magnitude
    (summation order only); ``sketch_bruteforce`` is ``sketch`` at L = 1,000
    on 40 of ``v``'s entries; ``round_unit``'s output has unit norm within
    1e-12."""
    from repro_torch.core import (DEFAULT_L, SparseVec, WeightedMinHash,
                                  make, round_unit, sketch_bruteforce)
    lo = SparseVec(indices=v.indices[::2], values=v.values[::2], n=v.n)
    hi = SparseVec(indices=v.indices[1::2], values=v.values[1::2], n=v.n)
    for method in ("mh", "kmv"):
        sk = make(method, PAPER_STORAGE, seed=0)
        if not same_sketch(sk.merge_union(sk.sketch(lo), sk.sketch(hi)),
                           sk.sketch(v)):
            raise AssertionError(f"paper baselines: {method} merge_union of "
                                 "the halves is not the whole's sketch")
    for method, arr in (("jl", "proj"), ("cs", "table")):
        sk = make(method, PAPER_STORAGE, seed=0)
        got = getattr(sk.merge(sk.sketch(lo), sk.sketch(hi)), arr)
        want = getattr(sk.sketch(v), arr)
        err = float(np.max(np.abs(got - want)))
        if not err <= 1e-12 * float(np.max(np.abs(want))):
            raise AssertionError(f"paper baselines: {method} merge is {err} "
                                 "from the sketch of the sum")
    small = SparseVec(indices=v.indices[:BRUTE_NNZ],
                      values=v.values[:BRUTE_NNZ], n=v.n)
    wmh = WeightedMinHash(m=int((PAPER_STORAGE - 1) / 1.5), seed=0, L=BRUTE_L)
    if not same_sketch(sketch_bruteforce(wmh, small), wmh.sketch(small)):
        raise AssertionError("paper baselines: sketch_bruteforce differs "
                             "from sketch")
    z = v.values / v.norm()
    for L in (BRUTE_L, DEFAULT_L):
        off = abs(float(np.linalg.norm(round_unit(z, L))) - 1.0)
        if not off <= 1e-12:
            raise AssertionError(f"paper baselines: round_unit at L = {L} "
                                 f"is {off} off unit norm")
    log("paper baselines: identities hold (MH and KMV merge_union of the "
        "halves == the whole's sketch; JL and CS merge within 1e-12 of the "
        f"table's scale; sketch_bruteforce == sketch at L = {BRUTE_L}, "
        f"{BRUTE_NNZ} entries; round_unit unit norm within 1e-12)")


def paper_baselines_phase():
    """The paper's head-to-head through the port's registry on the card's
    host, fig4's fast grid at storage 400: for every one of the nine
    ``FACTORIES`` the mean normalized error ``|est - <a,b>| / (||a|| ||b||)``
    an overlap and the host ms a sketch, beside ``fact1_bound`` and
    ``theorem2_bound`` an overlap; then the paper's method on the card,
    ``SketchCorpus(m=266)`` (m = (400 - 1) / 1.5, as the registry sizes
    ICWS) holding the ``a`` vectors, ``estimate_vec(b)`` answering each
    pair, beside the host ``icws`` row.  Stops on a failed identity
    (:func:`baseline_identities`); on a card estimate that is not finite;
    on card sketches of the rows and queries that fail the kernel's gate
    against a ``SketchCorpus(device="cpu")`` on the same vectors
    (:func:`sketch_agreement`); on an ``estimate_vec`` that is not, bit for
    bit, B3's plain version on the card's own sketches and the cpu
    corpus's estimate; and on a card estimate over
    ``PAPER_CARD_TOL`` from host ``icws``.  Times are warm
    medians.  Returns the report."""
    from repro_torch import SketchCorpus
    from repro_torch.core import (FACTORIES, fact1_bound, inner_fast, make,
                                  theorem2_bound)
    from repro_torch.kernels import estimate as ke
    from repro_torch.kernels import ops
    from repro_torch.data.synthetic import sparse_pair
    rng = np.random.default_rng(42)
    pairs = [(ov, a, b) for ov in PAPER_OVERLAPS
             for a, b in (sparse_pair(rng, overlap=ov)
                          for _ in range(PAPER_PAIRS))]
    baseline_identities(pairs[0][1])
    truth = [inner_fast(a, b) for _, a, b in pairs]
    scale = [a.norm() * b.norm() for _, a, b in pairs]
    bounds = {ov: {"fact1": statistics.fmean(
                       fact1_bound(a, b) for o, a, b in pairs if o == ov),
                   "theorem2": statistics.fmean(
                       theorem2_bound(a, b) for o, a, b in pairs if o == ov),
                   "theorem2_over_fact1": statistics.fmean(
                       theorem2_bound(a, b) / fact1_bound(a, b)
                       for o, a, b in pairs if o == ov)}
              for ov in PAPER_OVERLAPS}

    def errors(est):
        """The mean normalized error an overlap over pairs and seeds;
        ``est[seed][i]`` is pair i's estimate."""
        return {ov: statistics.fmean(
                    abs(e[i] - truth[i]) / scale[i] for e in est
                    for i, (o, _, _) in enumerate(pairs) if o == ov)
                for ov in PAPER_OVERLAPS}

    report, host_icws = {}, None
    for method in FACTORIES:
        est, sketch_s = [], 0.0
        for seed in range(PAPER_SEEDS):
            sk = make(method, PAPER_STORAGE, seed=seed)
            row = []
            for _, a, b in pairs:
                t0 = time.perf_counter()
                sa, sb = sk.sketch(a), sk.sketch(b)
                sketch_s += time.perf_counter() - t0
                row.append(sk.estimate(sa, sb))
            est.append(row)
        host_icws = est if method == "icws" else host_icws
        report[method] = {"err": errors(est), "host_ms_per_sketch": 1e3
                          * sketch_s / (2 * PAPER_SEEDS * len(pairs))}
    m = make("icws", PAPER_STORAGE).m
    avec = [a for _, a, _ in pairs]
    warm = SketchCorpus(m=m, device="cuda")    # first calls, untimed
    warm.add_batch(avec)
    warm.estimate_vec(pairs[0][2])
    del warm
    est, ingest_ms, query_ms, shares = [], [], [], []
    for seed in range(PAPER_SEEDS):
        corpus = SketchCorpus(m=m, seed=seed, device="cuda")
        t0 = time.perf_counter()
        corpus.add_batch(avec)
        torch.cuda.synchronize()
        ingest_ms.append(1e3 * (time.perf_counter() - t0) / len(avec))
        plain = SketchCorpus(m=m, seed=seed, device="cpu")
        plain.add_batch(avec)
        rows = corpus.arrays()
        fc, vc, nc, _ = rows
        shares.append(sketch_agreement("rows", rows, plain.arrays()))
        row = []
        for i, (_, _, b) in enumerate(pairs):
            t0 = time.perf_counter()
            got = corpus.estimate_vec(b)
            torch.cuda.synchronize()
            query_ms.append(1e3 * (time.perf_counter() - t0))
            if got.shape != (len(pairs),) or not bool(
                    torch.isfinite(got).all()):
                raise AssertionError("paper baselines: the card's "
                                     f"estimates {got} are not {len(pairs)} "
                                     "finite values")
            q = corpus.sketch_query(b)
            shares.append(sketch_agreement(f"query {i}", q,
                                           plain.sketch_query(b)))
            # B3 at m = 266 against its plain version on the card's
            # sketches, and the card against the plain corpus on the cpu
            want = ops._norm_epilogue(*ke.estimate_one_vs_many_plain(
                q[0], q[1], fc, vc), q[2][0], nc, m)
            if not bits_equal(got, want):
                raise AssertionError(f"paper baselines: seed {seed} query {i}:"
                                     f" the card's estimate_vec {got} is not "
                                     f"the plain estimate {want}")
            cpu = plain.estimate_vec(b)
            if not bits_equal(got.cpu(), cpu):
                raise AssertionError(f"paper baselines: seed {seed} query {i}:"
                                     f" the card's estimate_vec {got} is not "
                                     f"the cpu corpus's {cpu}")
            row.append(float(got[i]))
        est.append(row)
    dist = max(abs(e - h) / scale[i] for er, hr in zip(est, host_icws)
               for i, (e, h) in enumerate(zip(er, hr)))
    if not dist <= PAPER_CARD_TOL:
        raise AssertionError(f"paper baselines: the card's estimates are "
                             f"{dist} (normalized) from host icws, over "
                             f"{PAPER_CARD_TOL}")
    report["icws card"] = {
        "err": errors(est), "m": m,
        "ingest_ms_per_vector": statistics.median(ingest_ms),
        "estimate_vec_ms": statistics.median(query_ms),
        "min_fp_agree_vs_plain": min(shares),
        "max_norm_dist_from_host_icws": dist}
    log(f"paper baselines: card SketchCorpus(m={m}): fingerprints agree "
        f"with the plain sketch on >= {min(shares):.6f} of slots (gate "
        f"0.99), values and argkeys equal where they agree; estimate_vec "
        f"equals the plain estimate of the card's sketches and the cpu "
        f"corpus's bit for bit ({PAPER_SEEDS * len(pairs)} queries); "
        f"{dist:.4g} (normalized) "
        f"from host icws (gate {PAPER_CARD_TOL:g}); warm medians: ingest "
        f"{statistics.median(ingest_ms):.4f} ms a vector, estimate_vec "
        f"{statistics.median(query_ms):.4f} ms")
    log(f"paper baselines: normalized error |est - <a,b>| / (||a|| ||b||), "
        f"mean of {PAPER_PAIRS} pairs x {PAPER_SEEDS} seeds an overlap, "
        f"storage {PAPER_STORAGE}; host ms a sketch")
    log(f"  {'method':<10}" + "".join(f"{f'ov {ov:g}':>10}"
                                      for ov in PAPER_OVERLAPS) + "  ms")
    rows = list(FACTORIES)
    rows.insert(rows.index("icws") + 1, "icws card")
    for method in rows:
        r = report[method]
        ms = r.get("host_ms_per_sketch")
        log(f"  {method:<10}" + "".join(f"{r['err'][ov]:>10.5f}"
                                        for ov in PAPER_OVERLAPS)
            + (f"  {ms:.3f}" if ms is not None else ""))
    log("  theorem2 / fact1 (eps = 1, mean of the pairs): " + ", ".join(
        f"ov {ov:g} {b['theorem2']:.1f} / {b['fact1']:.1f} = "
        f"{b['theorem2_over_fact1']:.4f}" for ov, b in bounds.items()))
    report["bounds"] = bounds
    log("paper baselines (" + card_identity() + "): " + json.dumps(report))
    return report


def sample_extra(name, rep):
    """B9 and B13 are one templated body: each entry names its kernel's
    symbol, the traced name, and its headline case's issue floor and
    groups.  Nothing for the other kernels."""
    if name not in ("sample_estimate_fields", "sample_estimate_fields_packed"):
        return {}
    return {"symbol": name + "_kernel", "traced": rep["kernel"],
            "floor_ms_issue": rep["floor_ms_issue"],
            "instr_per_lookup": rep["instr_per_lookup"],
            "groups": rep["groups"], "items_per_block": rep["items_per_block"]}


def dmh_extra(name, rep):
    """B5's entry names its headline case's issue floor, its SASS
    instructions a lane and its launch shape; nothing for the others."""
    if name != "dmh_sketch":
        return {}
    return {"floor_ms_issue": rep["floor_ms_issue"],
            "instr_per_lane": rep["instr_per_lane"],
            "cluster": rep["cluster"], "threads": rep["threads"]}


def kernel_entry(name, source, replaces, launches, rep, shapes, **extra):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches, "max_abs_err": rep["max_abs_err"],
            "ms": rep["ms"], "device_ms": rep["device_ms"],
            "device_ms_source": rep["device_ms_source"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep.get("bound_by", "operations"),
            "library_ms": rep.get("library_ms"), "shape": rep["shape"],
            "all_shapes": shapes, **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    # f32 products in full f32 (the flash-attention tolerance rules out TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    identity = card_identity()
    log(identity)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")
    phase("build", build_phase)
    phase("norm epilogue", norm_epilogue_phase)
    sketch, estimate, icws_data = phase("icws kernels", kernel_phase, dev)
    lin_sketch, lin_estimate, lin_data = phase(
        "linear kernels", linear_kernel_phase, dev)
    dmh = phase("dmh kernel", dmh_kernel_phase, dev, sketch)
    sample, sample_data = phase("sample estimate kernel",
                                sample_kernel_phase, dev)
    b10, b11, b12, b13 = phase("packed kernels", packed_kernel_phase, dev,
                               icws_data, lin_data, sample_data)
    b3_pairs, b3_one, b4 = phase("corpus kernels", corpus_kernel_phase,
                                 icws_data)
    del icws_data, lin_data, sample_data
    torch.cuda.empty_cache()
    b14 = phase("compression kernel", compression_kernel_phase)
    torch.cuda.empty_cache()
    compression_launches = phase("compression", compression_phase)
    torch.cuda.empty_cache()
    axis_launches = phase("compression replica axis", compression_axis_phase)
    torch.cuda.empty_cache()
    b15, flash_launches = phase("flash attention kernel",
                                flash_attention_kernel_phase)
    torch.cuda.empty_cache()
    phase("lm serve", lm_serve_phase, identity)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, b1_train, b3_train = phase("lm train", lm_train_phase,
                                               identity)
    gc.collect()
    torch.cuda.empty_cache()
    phase("lm moe", lm_moe_phase, identity)
    gc.collect()
    torch.cuda.empty_cache()
    phase("lm vlm", lm_vlm_phase, identity)
    gc.collect()
    torch.cuda.empty_cache()
    for family in FAMILIES:
        phase(f"small lake {family}", small_reference_phase, dev, family)
    lake = phase("lake", lake_phase)
    corpus_launches, corpus_sharded = phase("corpus", corpus_phase, lake)
    runs, packed_runs, latency, b10_path, sharded = {}, {}, {}, {}, {}
    for family in FAMILIES:
        (runs[family], packed_runs[family], latency[family],
         b10_path[family], sharded[family]) = family_phases(family, lake)
    merge_launches = phase("merge", merge_phase, lake)
    phase("host oracle", host_oracle_phase, lake)
    phase("paper baselines", paper_baselines_phase)
    for label, rs in (("unpacked", runs), ("packed", packed_runs)):
        log(f"planted-partner recall ({label}), top 10 / ranked first, of "
            f"{QUERIES // 2}: " + ", ".join(
                f"{f} {r[1]['in_top10']}/{r[1]['first']}"
                for f, r in rs.items()))
    # a kernel's launches: the sum over every serving run, unpacked and
    # packed, the merge phase's sharded builds and their queries (apart,
    # "sharded_build_launches") and the sharded serving runs, the sharded
    # corpus's among them (apart, "sharded_serving_launches"); B10 is on
    # none of them, and its own path's count is "entry_point_launches"
    sharded_launches = {name: sum(r[0][name] for r in sharded.values())
                        + corpus_sharded[name] for name in launch_counters()}
    launches = {name: sum(r[0][name] for rs in (runs, packed_runs)
                          for r in rs.values()) + merge_launches[name]
                + sharded_launches[name] for name in launch_counters()}

    rep = sketch[3]   # the query micro-batch launch: B = 48, N = 4096
    kernels = [
        kernel_entry(name, source, replaces, launches[name], r, shapes,
                     sharded_build_launches=merge_launches[name],
                     sharded_serving_launches=sharded_launches[name],
                     **sample_extra(name, r), **dmh_extra(name, r))
        for name, source, replaces, r, shapes in (
            ("icws_sketch", "icws_sketch.cu", "icws_sketch.py:40", rep,
             sketch),
            ("estimate_fields", "estimate_fields.cu", "estimate.py:215",
             estimate[0], estimate),
            ("countsketch_sparse", "countsketch_sparse.cu",
             "countsketch.py:91", lin_sketch["cs"][3], lin_sketch["cs"]),
            ("jl_sketch", "jl_sketch.cu", "jl_sketch.py:28",
             lin_sketch["jl"][3], lin_sketch["jl"]),
            ("linear_estimate_fields", "linear_estimate_fields.cu",
             "estimate.py:407", lin_estimate[0], lin_estimate),
            ("dmh_sketch", "dmh_sketch.cu", "dmh_sketch.py:92", dmh[3], dmh),
            ("sample_estimate_fields", "sample_estimate_fields.cu",
             "sample_estimate.py:86", sample[0], sample),
            ("estimate_fields_packed", "estimate_fields.cu",
             "estimate.py:306", b11[0], b11),
            ("linear_estimate_fields_packed", "linear_estimate_fields.cu",
             "estimate.py:500", b12[0], b12),
            ("sample_estimate_fields_packed", "sample_estimate_fields.cu",
             "sample_estimate.py:204", b13[0], b13))]
    kernels[7:7] = [
        kernel_entry(f"{kind}_sketch_packed", f"{kind}_sketch.cu", replaces,
                     launches[f"{kind}_sketch_packed"], b10[kind][1],
                     b10[kind], entry_point_launches=b10_path[kind],
                     sharded_serving_launches=sharded_launches[
                         f"{kind}_sketch_packed"],
                     entry_point=f"repro_torch.kernels.ops.{kind}_sketch("
                                 "pack_vals=True)")
        for kind, replaces in (("icws", "icws_sketch.py:96"),
                               ("dmh", "dmh_sketch.py:157"))]
    # B3 and B4 run on the corpus path (SketchCorpus, ops.icws_estimate),
    # not on the service's: their launches are that path's, the sharded
    # corpus's included
    kernels[2:2] = [
        kernel_entry(name, source, replaces,
                     corpus_launches[name] + sharded_launches[name], r,
                     shapes, sharded_serving_launches=sharded_launches[name])
        for name, source, replaces, r, shapes in (
            ("estimate_pairs", "estimate_pairs.cu", "estimate.py:49", b3_pairs,
             [b3_pairs]),
            ("estimate_one_vs_many", "estimate_pairs.cu", "estimate.py:49",
             b3_one[0], b3_one),
            ("estimate_many", "estimate_fields.cu", "estimate.py:153", b4[0],
             b4))]
    kernels[0]["corpus_path_launches"] = corpus_launches["icws_sketch"]
    # B14 and B15 run on their own paths: compressed_update and the
    # flash_attention entry point; B15 as one entry a kernel, each with the
    # reports of the cases routed to it (the first its headline).  Their
    # counters are set to 0 and read around the sharded serving runs like
    # every other kernel's; B14's named-axis steps stand apart as
    # "replica_axis_launches"
    kernels.append(
        kernel_entry("countsketch_dense", "countsketch_dense.cu",
                     "countsketch.py:35", compression_launches + axis_launches,
                     b14[0], b14,
                     sharded_serving_launches=sharded_launches[
                         "countsketch_dense"],
                     replica_axis_launches=axis_launches,
                     entry_point="repro_torch.optim.compression."
                                 "compressed_update",
                     floor_ms_issue=b14[0]["floor_ms_issue"],
                     instr_per_term=b14[0]["instr_per_term"]))
    for name, symbol in (("flash_attention_tc", "flash_attention_tc_kernel"),
                         ("flash_attention_f32tc",
                          "flash_attention_f32tc_kernel")):
        shapes = [r for r in b15 if r["kernel"] == symbol]
        kernels.append(kernel_entry(
            name, "flash_attention.cu", "flash_attention.py:28",
            flash_launches[symbol], shapes[0], shapes,
            sharded_serving_launches=sharded_launches[name],
            entry_point="repro_torch.kernels.flash_attention."
                        "flash_attention"))
    # the training path's telemetry launches B1 and B3 (its own counts,
    # "train_launches", added into each entry's launches; 0 elsewhere), at
    # the shapes in "train_path"
    for entry in kernels:
        entry["train_launches"] = train_launches[entry["name"]]
        entry["launches"] += entry["train_launches"]
    kernels[0]["train_path"] = b1_train
    next(e for e in kernels if e["name"] == "estimate_pairs")[
        "train_path"] = b3_train
    log("latency (unpacked; packed), p50 ms of search and of a micro-batch "
        "of 16: " + json.dumps(latency))
    log(f"sharded search p50 ms (A single device, B {SHARDS[0]} shards of "
        f"cuda:0, turns {SHARDED_TURNS}) on {identity}: "
        + json.dumps({f: r[1] for f, r in sharded.items()}))
    log(f"total {time.perf_counter() - t_start:.1f} s on {identity}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
